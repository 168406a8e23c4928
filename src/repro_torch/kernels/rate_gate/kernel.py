"""Wrappers of the hand-written Rate-Limiter gate kernels, which replace
the TPU kernels of ``repro/kernels/rate_gate/kernel.py``:

* :data:`fused_gate` and :data:`fused_gate_prng` (``csrc/fused_gate.cu``)
  replace ``fused_gate_pallas``, rand-input and on-core-PRNG variants;
  plain versions ``ref.fused_admission_ref`` and
  ``ref.fused_admission_prng_ref``;
* :data:`rate_gate` and :data:`rate_gate_prng` (``csrc/rate_gate.cu``)
  replace ``rate_gate_pallas``, both variants; plain versions
  ``ref.rate_gate_ref`` and ``ref.rate_gate_prng_ref``.

The drawing variants take a threefry key as a [2] int64 tensor on the
card (``core.prng``'s layout) and read it there, so a call inside the
replay loop never waits for the host.  Each wrapper counts its launches
in ``launches``.

The fused pair also admits the batches of P pipes in one launch (the
multi-pipe driver's step): lanes [P, n], LUTs [P, TB, CB], registers [P]
and keys [P, 2] give granted [P, n] and bucket' [P].  The 1-D form is
the P = 1 case of the same launch.

:data:`threefry_draw` (``csrc/threefry_draw.cu``) replaces no TPU kernel:
it is the chunk step's threefry split and the gate's draws, every pipe's
in one launch, in place of the plain version's ~510 elementwise kernels
(``ref.threefry_draw_ref``, which the CPU runs).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.kernels import _build

_VP, _I = ctypes.c_void_p, ctypes.c_int
LUT_BYTES_MAX = 48 * 1024          # static shared memory of one CTA


def _check_lane(x: torch.Tensor, name: str, shape: Tuple[int, ...],
                kernel: str) -> None:
    if x.dtype != torch.int32 or x.shape != shape or not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous "
                         f"{list(shape)} int32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _check_prob_bits(prob_bits: int, kernel: str) -> None:
    # the kernel draws only randint's lower bits: valid when the span's
    # multiplier of the higher bits is 0, as for every power of two
    if not 1 <= prob_bits <= 31 \
            or prng.randint_multiplier(1 << prob_bits) != 0:
        raise ValueError(f"{kernel}: prob_bits must be in [1, 31]")


class _GateKernel:
    """Callable kernel wrapper; ``launches`` counts kernel launches (a
    CUDA-graph replay adds the launches recorded at its capture:
    ``_graph.Graph.replay``)."""

    name = ""
    symbol = ""
    argtypes: Tuple = ()

    def __init__(self):
        self.launches = 0

    def _check(self, lanes, lut: torch.Tensor, key=None, regs=()
               ) -> Tuple[int, int]:
        """Common checks: one CUDA device; contiguous int32 ``lanes``
        (name, tensor), all [n] or all [P, n] (P pipes), n >= 1; an int32
        LUT that fits in shared memory, [TB, CB] for [n] lanes and [P, TB,
        CB] for [P, n]; the ``key`` where the kernel takes one ([2] or [P,
        2]); and the int32 registers ``regs`` (name, tensor), one element a
        pipe.  Returns (P, n): P = 1 for [n] lanes."""
        shape = tuple(lanes[0][1].shape)
        piped = len(shape) == 2
        pipes, n = shape if piped else (1, shape[0] if shape else 0)
        tensors = [x for _, x in lanes] + [lut] + [x for _, x in regs] + (
            [key] if key is not None else [])
        if any(not x.is_cuda or x.device != tensors[0].device
               for x in tensors):
            raise ValueError(f"{self.name} runs on CUDA tensors of one "
                             "device")
        if len(shape) not in (1, 2) or n < 1 or pipes < 1:
            raise ValueError(f"{self.name} needs [n] or [P, n] lanes, n "
                             f">= 1; got {list(shape)}")
        for name, x in lanes:
            _check_lane(x, name, shape, self.name)
        if lut.dtype != torch.int32 or lut.dim() != 2 + piped \
                or (piped and lut.shape[0] != pipes) \
                or not lut.is_contiguous():
            raise ValueError(f"{self.name}: lut must be a contiguous int32 "
                             f"{'[P, TB, CB]' if piped else '[TB, CB]'} "
                             "tensor")
        if lut.shape[-2] * lut.shape[-1] * 4 > LUT_BYTES_MAX:
            raise ValueError(f"{self.name}: the LUT must fit in 48 KB of "
                             "shared memory")
        if key is not None and (key.dtype != torch.int64
                                or key.shape != ((pipes, 2) if piped
                                                 else (2,))
                                or not key.is_contiguous()):
            raise ValueError(f"{self.name}: key must be a contiguous int64 "
                             "threefry key (uint32 words), [2] or [P, 2]")
        for name, x in regs:
            if x.dtype != torch.int32 or x.numel() != pipes \
                    or not x.is_contiguous():
                raise ValueError(f"{self.name}: {name} must be an int32 "
                                 "tensor of one element a pipe")
        return pipes, n

    def _check_1d(self, lanes, lut: torch.Tensor, key=None) -> int:
        """``_check`` for the selection-only kernels: [n] lanes only."""
        if lanes[0][1].dim() != 1:
            raise ValueError(f"{self.name} takes [n] lanes, got "
                             f"{list(lanes[0][1].shape)}")
        return self._check(lanes, lut, key=key)[1]

    def _launch(self, *args) -> None:
        fn = _build.function(self.symbol, self.argtypes)
        _build.check(fn(*args), self.name)
        self.launches += 1


class _FusedGate(_GateKernel):
    """Fused admission of one batch on the card, rand-input variant."""

    name, symbol = "fused_gate", "fused_gate_launch"
    argtypes = (_VP,) * 10 + (_I,) * 9 + (_VP,)

    def __call__(self, t_i: torch.Tensor, c_i: torch.Tensor,
                 ts: torch.Tensor, rand16: torch.Tensor, lut: torch.Tensor,
                 bucket: torch.Tensor, t_last: torch.Tensor, *, t_shift: int,
                 c_shift: int, cost_us: int, bucket_cap_us: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """t_i, c_i, ts, rand16 [n] int32 (n >= 1; no padding, any
        alignment); lut [TB, CB] int32; bucket, t_last: the batch-start
        token-bucket registers, one int32 each on the device (the kernel
        derives the refill anchor and the burst cap from them).  Returns
        (granted [n] bool, bucket_new 0-d int32), both on the device;
        nothing is read back to the host.  P pipes' batches in one launch:
        lanes [P, n], lut [P, TB, CB], registers [P] -> ([P, n], [P])."""
        pipes, n = self._check([("t_i", t_i), ("c_i", c_i), ("ts", ts),
                                ("rand16", rand16)], lut,
                               regs=[("bucket", bucket),
                                     ("t_last", t_last)])
        granted, bucket_new, scratch = _gate_outputs(t_i.shape, pipes, n,
                                                     t_i.device, False)
        tb, cb = lut.shape[-2:]
        self._launch(t_i.data_ptr(), c_i.data_ptr(), ts.data_ptr(),
                     rand16.data_ptr(), lut.data_ptr(), bucket.data_ptr(),
                     t_last.data_ptr(), granted.data_ptr(),
                     bucket_new.data_ptr(), *_scratch_args(scratch), pipes,
                     n, tb, cb, t_shift, c_shift, cost_us, bucket_cap_us,
                     _stream(t_i))
        return granted, _bucket_out(bucket_new, t_i)


class _FusedGatePrng(_GateKernel):
    """Fused admission of one batch on the card, drawing its own bits
    from the chunk's threefry subkey ``key``."""

    name, symbol = "fused_gate_prng", "fused_gate_prng_launch"
    argtypes = (_VP,) * 10 + (_I,) * 10 + (_VP,)

    def __call__(self, t_i: torch.Tensor, c_i: torch.Tensor,
                 ts: torch.Tensor, key: torch.Tensor, lut: torch.Tensor,
                 bucket: torch.Tensor, t_last: torch.Tensor, *, t_shift: int,
                 c_shift: int, prob_bits: int, cost_us: int,
                 bucket_cap_us: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """As :data:`fused_gate`, with ``rand16`` replaced by the draws
        ``prng.randint(key, n, 0, 2^prob_bits)`` made in the kernel (a
        key [P, 2] for lanes [P, n]: each pipe draws from its own)."""
        pipes, n = self._check([("t_i", t_i), ("c_i", c_i), ("ts", ts)],
                               lut, key=key,
                               regs=[("bucket", bucket),
                                     ("t_last", t_last)])
        _check_prob_bits(prob_bits, self.name)
        granted, bucket_new, scratch = _gate_outputs(t_i.shape, pipes, n,
                                                     t_i.device, True)
        tb, cb = lut.shape[-2:]
        self._launch(t_i.data_ptr(), c_i.data_ptr(), ts.data_ptr(),
                     key.data_ptr(), lut.data_ptr(), bucket.data_ptr(),
                     t_last.data_ptr(), granted.data_ptr(),
                     bucket_new.data_ptr(), *_scratch_args(scratch), pipes,
                     n, tb, cb, t_shift, c_shift, prob_bits, cost_us,
                     bucket_cap_us, _stream(t_i))
        return granted, _bucket_out(bucket_new, t_i)


class _RateGate(_GateKernel):
    """Selection-only gate on the card, rand-input variant."""

    name, symbol = "rate_gate", "rate_gate_launch"
    argtypes = (_VP,) * 5 + (_I,) * 5 + (_VP,)

    def __call__(self, t_i: torch.Tensor, c_i: torch.Tensor,
                 rand16: torch.Tensor, lut: torch.Tensor, *, t_shift: int,
                 c_shift: int) -> torch.Tensor:
        """t_i, c_i, rand16 [n] int32; lut [TB, CB] int32 -> selected
        [n] bool on the device."""
        n = self._check_1d([("t_i", t_i), ("c_i", c_i),
                            ("rand16", rand16)], lut)
        out = torch.empty((n,), dtype=torch.bool, device=t_i.device)
        tb, cb = lut.shape
        self._launch(t_i.data_ptr(), c_i.data_ptr(), rand16.data_ptr(),
                     lut.data_ptr(), out.data_ptr(), n, tb, cb, t_shift,
                     c_shift, _stream(t_i))
        return out


class _RateGatePrng(_GateKernel):
    """Selection-only gate on the card, drawing its own bits from
    ``key``."""

    name, symbol = "rate_gate_prng", "rate_gate_prng_launch"
    argtypes = (_VP,) * 5 + (_I,) * 6 + (_VP,)

    def __call__(self, t_i: torch.Tensor, c_i: torch.Tensor,
                 key: torch.Tensor, lut: torch.Tensor, *, t_shift: int,
                 c_shift: int, prob_bits: int) -> torch.Tensor:
        """As :data:`rate_gate`, with ``rand16`` replaced by the draws
        ``prng.randint(key, n, 0, 2^prob_bits)`` made in the kernel."""
        n = self._check_1d([("t_i", t_i), ("c_i", c_i)], lut, key=key)
        _check_prob_bits(prob_bits, self.name)
        out = torch.empty((n,), dtype=torch.bool, device=t_i.device)
        tb, cb = lut.shape
        self._launch(t_i.data_ptr(), c_i.data_ptr(), key.data_ptr(),
                     lut.data_ptr(), out.data_ptr(), n, tb, cb, t_shift,
                     c_shift, prob_bits, _stream(t_i))
        return out


class _ThreefryDraw(_GateKernel):
    """The chunk step's threefry split and the gate's draws on the card,
    every pipe's in one launch."""

    name, symbol = "threefry_draw", "threefry_draw_launch"
    argtypes = (_VP,) * 4 + (_I,) * 3 + (_VP,)

    def __call__(self, key: torch.Tensor, n: int, prob_bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """key [P, 2] int64 (each pipe's threefry key, uint32 words) ->
        (key' [P, 2], sub [P, 2], rand16 [P, n] int32): ``split(key)[:,
        0]``, ``split(key)[:, 1]`` and ``randint(sub, n, 0,
        2^prob_bits)``, as ``ref.threefry_draw_ref`` gives them.  n = 0
        gives the split alone.  Out of place; nothing is read back."""
        if not key.is_cuda:
            raise ValueError(f"{self.name} runs on CUDA tensors")
        if key.dtype != torch.int64 or key.dim() != 2 \
                or key.shape[1] != 2 or not 1 <= key.shape[0] <= 65535 \
                or not key.is_contiguous():
            raise ValueError(f"{self.name}: key must be a contiguous [P, "
                             "2] int64 tensor of threefry keys (uint32 "
                             f"words), 1 <= P <= 65535; got {key.dtype} "
                             f"{tuple(key.shape)}")
        if not 0 <= n < 2**31:
            raise ValueError(f"{self.name}: n must be in [0, 2^31), got "
                             f"{n}")
        _check_prob_bits(prob_bits, self.name)
        pipes = key.shape[0]
        key_new, sub = torch.empty_like(key), torch.empty_like(key)
        rand16 = torch.empty((pipes, n), dtype=torch.int32,
                             device=key.device)
        self._launch(key.data_ptr(), key_new.data_ptr(), sub.data_ptr(),
                     rand16.data_ptr(), pipes, n, prob_bits, _stream(key))
        return key_new, sub, rand16


@functools.lru_cache(maxsize=64)
def _scratch_words(n: int, draw: bool) -> int:
    """The int64 words of look-back scratch a batch of ``n`` lanes needs:
    0 up to one cluster's batch.  Asked of the library once per size."""
    return _build.function("fused_gate_scratch_words", (_I, _I))(n, draw)


def _gate_outputs(shape, pipes: int, n: int, device, draw: bool) -> Tuple[
        torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """granted (the lanes' ``shape``) bool, bucket [pipes] int32 and the
    look-back's int64 scratch of every pipe, which the launcher zeroes
    (None up to one cluster's batch: that path takes none)."""
    words = _scratch_words(n, draw) * pipes
    return (torch.empty(shape, dtype=torch.bool, device=device),
            torch.empty((pipes,), dtype=torch.int32, device=device),
            torch.empty((words,), dtype=torch.int64, device=device)
            if words else None)


def _bucket_out(bucket: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """bucket' [P] for [P, n] lanes, 0-d for [n]."""
    return bucket if lanes.dim() == 2 else bucket[0]


def _scratch_args(x: Optional[torch.Tensor]) -> Tuple[Optional[int], int]:
    """(pointer, words) of the scratch: (NULL, 0) where there is none."""
    return (None, 0) if x is None else (x.data_ptr(), x.numel())


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


fused_gate = _FusedGate()
fused_gate_prng = _FusedGatePrng()
rate_gate = _RateGate()
rate_gate_prng = _RateGatePrng()
threefry_draw = _ThreefryDraw()
