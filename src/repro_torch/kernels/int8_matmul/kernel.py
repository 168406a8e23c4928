"""Wrapper of the hand-written INT8 GEMM (``csrc/int8_gemm.cu``), which
replaces the TPU kernel
``repro/kernels/int8_matmul/kernel.py::int8_matmul_pallas``.  The plain
version of the same function is ``ref.int8_matmul_ref``.

The kernel reads B K-major (``b.stride(0) == 1``: column n of B is a
contiguous run of K bytes), the layout its tensor-core fragments take;
the serving weights are packed so at load (``ops.k_major``).  The tile
shape is picked per call on the host by :func:`gemm_tile`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_VP] * 4 + [_I] * 3 + [_LL] * 2 + [_I] * 3 + [_VP]
# (BM, BN) of the kernel's tile shapes, largest first (csrc/int8_gemm.cu
# dispatch_tile, in this order)
TILES = ((128, 128), (128, 64), (64, 64), (64, 32), (32, 32), (32, 8))
# gemm_tile's aim, from a sweep of every tile at the serving shapes on the
# H100 (PERF.md): two CTAs a SM hide the short k-loops' load latency
CTAS_PER_SM = 2
_SM_COUNT: Dict[int, int] = {}


def gemm_tile(m: int, n: int, sm_count: int) -> int:
    """Index into ``TILES`` for an [m, n] output: the largest tile that
    gives at least ``CTAS_PER_SM`` CTAs a SM, else the smallest, among
    the tiles less than twice as wide as ``n`` (a wider one would compute
    mostly padding), the 8-wide one only when no other is."""
    fits = [i for i, (_, bn) in enumerate(TILES) if bn < 2 * n]
    if len(fits) > 1:
        fits = [i for i in fits if TILES[i][1] > 8]
    fits = fits or [len(TILES) - 1]
    for i in fits:
        bm, bn = TILES[i]
        if -(-m // bm) * -(-n // bn) >= CTAS_PER_SM * sm_count:
            return i
    return fits[-1]


def copy_width(k: int, lda: int, ldb: int, *ptrs: int) -> int:
    """Bytes of one async copy (16, 4 or 1): the widest that divides K,
    both leading dimensions and every operand address."""
    for w in (16, 4):
        if not (k % w or lda % w or ldb % w or any(p % w for p in ptrs)):
            return w
    return 1


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _lib():
    return _build.function("int8_gemm_launch", _ARGTYPES)


class _Int8Gemm:
    """Callable kernel wrapper; ``launches`` counts kernel launches (a
    CUDA-graph replay adds the launches recorded at its capture:
    ``_graph.Graph.replay``)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 shift: Optional[int] = None,
                 tile: Optional[int] = None) -> torch.Tensor:
        """a [M,K] int8 contiguous, b [K,N] int8 K-major
        (``b.stride(0) == 1``, any column stride >= K), bias [N] int32
        (optional), all CUDA tensors -> [M,N] int8 when ``shift`` is
        given (0 <= shift < 31), raw int32 otherwise.  Ragged M/N/K are
        masked inside the kernel; nothing is padded or transposed.
        ``tile`` (an index into ``TILES``) overrides :func:`gemm_tile`,
        for measurement."""
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
        if not a.is_contiguous() or (bias is not None
                                     and not bias.is_contiguous()):
            raise ValueError("int8_gemm takes contiguous a and bias")
        ldb = b.stride(1) if n > 1 else k
        if (b.stride(0) != 1 and k > 1) or ldb < k:
            raise ValueError("int8_gemm takes b K-major (b.stride(0) == 1, "
                             "e.g. ops.k_major(b)); got strides "
                             f"{b.stride()} for shape {tuple(b.shape)}")
        if bias is not None and (bias.dtype != torch.int32
                                 or bias.shape != (n,)):
            raise ValueError("int8_gemm: bias must be [N] int32")
        if shift is not None and not 0 <= shift < 31:
            raise ValueError(f"int8_gemm: shift {shift} outside [0, 31)")
        if tile is not None and tile not in range(len(TILES)):
            raise ValueError(f"int8_gemm: tile {tile} not an index into "
                             f"{TILES}")
        fn = _lib()
        out = torch.empty((m, n), device=a.device,
                          dtype=torch.int32 if shift is None else torch.int8)
        if m == 0 or n == 0:
            return out
        if tile is None:
            tile = gemm_tile(m, n, _sm_count(a.device))
        width = copy_width(k, k, ldb, a.data_ptr(), b.data_ptr())
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = fn(a.data_ptr(), b.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), m, n, k, k, ldb,
                    -1 if shift is None else shift, tile, width, stream)
        _build.check(status, "int8_gemm")
        self.launches += 1
        return out


int8_gemm = _Int8Gemm()
