"""Wrapper of the hand-written INT8 GEMM (``csrc/int8_gemm.cu``), which
replaces the TPU kernel
``repro/kernels/int8_matmul/kernel.py::int8_matmul_pallas``.  The plain
version of the same function is ``ref.int8_matmul_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 4 + [_I] * 4 + [_VP]


def _lib():
    return _build.function("int8_gemm_launch", _ARGTYPES)


class _Int8Gemm:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 shift: Optional[int] = None) -> torch.Tensor:
        """a [M,K] int8, b [K,N] int8, bias [N] int32 (optional), all
        contiguous CUDA tensors -> [M,N] int8 when ``shift`` is given
        (0 <= shift < 31), raw int32 otherwise.  Ragged M/N/K are masked
        inside the kernel; nothing is padded."""
        if a.dtype != torch.int8 or b.dtype != torch.int8 \
                or a.dim() != 2 or b.dim() != 2:
            raise ValueError("int8_gemm takes 2-D int8 operands, got "
                             f"{a.dtype} {tuple(a.shape)} and {b.dtype} "
                             f"{tuple(b.shape)}")
        m, k = a.shape
        k2, n = b.shape
        if k != k2:
            raise ValueError(f"int8_gemm: inner dims differ ({k} vs {k2})")
        operands = (a, b) if bias is None else (a, b, bias)
        if any(not x.is_cuda or x.device != a.device for x in operands):
            raise ValueError("int8_gemm runs on CUDA tensors of one "
                             "device")
        if any(not x.is_contiguous() for x in operands):
            raise ValueError("int8_gemm takes contiguous tensors")
        if bias is not None and (bias.dtype != torch.int32
                                 or bias.shape != (n,)):
            raise ValueError("int8_gemm: bias must be [N] int32")
        if shift is not None and not 0 <= shift < 31:
            raise ValueError(f"int8_gemm: shift {shift} outside [0, 31)")
        fn = _lib()
        out = torch.empty((m, n), device=a.device,
                          dtype=torch.int32 if shift is None else torch.int8)
        if m == 0 or n == 0:
            return out
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = fn(a.data_ptr(), b.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), m, n, k,
                    -1 if shift is None else shift, stream)
        _build.check(status, "int8_gemm")
        self.launches += 1
        return out


int8_gemm = _Int8Gemm()
