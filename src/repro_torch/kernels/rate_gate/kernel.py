"""Wrapper of the hand-written fused admission kernel
(``csrc/fused_gate.cu``), which replaces the TPU kernel
``repro/kernels/rate_gate/kernel.py::fused_gate_pallas`` (rand-input
variant).  The plain version of the same function is
``ref.fused_admission_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 8 + [_I] * 7 + [_VP]


def _lib():
    return _build.function("fused_gate_launch", _ARGTYPES)


def _check_lane(x: torch.Tensor, name: str, n: int) -> None:
    if x.dtype != torch.int32 or x.shape != (n,) or not x.is_contiguous():
        raise ValueError(f"fused_gate: {name} must be a contiguous [n] "
                         f"int32 tensor, got {x.dtype} {tuple(x.shape)}")


class _FusedGate:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, t_i: torch.Tensor, c_i: torch.Tensor,
                 ts: torch.Tensor, rand16: torch.Tensor, lut: torch.Tensor,
                 scal: torch.Tensor, *, t_shift: int, c_shift: int,
                 cost_us: int, bucket_cap_us: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused admission of one batch on the card.

        t_i, c_i, ts, rand16  [n] int32 (n >= 1; no padding needed)
        lut                   [TB, CB] int32
        scal                  [2] int32 on the device: (burst0, t_ref)

        Returns (granted [n] bool, bucket_new 0-d int32), both on the
        device; nothing is read back to the host.
        """
        n = t_i.shape[0]
        tensors = (t_i, c_i, ts, rand16, lut, scal)
        if any(not x.is_cuda or x.device != t_i.device for x in tensors):
            raise ValueError("fused_gate runs on CUDA tensors of one "
                             "device")
        if n < 1:
            raise ValueError("fused_gate needs a batch of at least one "
                             "packet")
        for x, name in ((t_i, "t_i"), (c_i, "c_i"), (ts, "ts"),
                        (rand16, "rand16")):
            _check_lane(x, name, n)
        if lut.dtype != torch.int32 or lut.dim() != 2 \
                or not lut.is_contiguous():
            raise ValueError("fused_gate: lut must be a contiguous 2-D "
                             "int32 tensor")
        if lut.numel() * 4 > 48 * 1024:
            raise ValueError("fused_gate: the LUT must fit in 48 KB of "
                             "shared memory")
        if scal.dtype != torch.int32 or scal.shape != (2,) \
                or not scal.is_contiguous():
            raise ValueError("fused_gate: scal must be a contiguous [2] "
                             "int32 tensor (burst0, t_ref)")
        fn = _lib()
        granted = torch.empty((n,), dtype=torch.bool, device=t_i.device)
        bucket = torch.empty((1,), dtype=torch.int32, device=t_i.device)
        tb, cb = lut.shape
        stream = torch.cuda.current_stream(t_i.device).cuda_stream
        status = fn(t_i.data_ptr(), c_i.data_ptr(), ts.data_ptr(),
                    rand16.data_ptr(), lut.data_ptr(), scal.data_ptr(),
                    granted.data_ptr(), bucket.data_ptr(), n, tb, cb,
                    t_shift, c_shift, cost_us, bucket_cap_us, stream)
        _build.check(status, "fused_gate")
        self.launches += 1
        return granted, bucket[0]


fused_gate = _FusedGate()
