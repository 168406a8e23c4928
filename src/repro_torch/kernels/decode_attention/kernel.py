"""Wrapper of the hand-written GQA decode-attention kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``.
The plain version of the same function is ``ref.decode_attention_ref``;
``ref.decode_attention_split_ref`` is the plain version of the kernel's
split-and-merge algorithm.

The kernel splits each sequence across the CTAs of a thread-block
cluster (flash-decoding in one launch).  How many, :func:`num_splits`
decides on the host from shapes and the SM count only, so the decode
loop never reads ``lengths`` back.  It takes any GQA group, as the TPU
kernel does: a CTA computes a tile of at most ``GROUP_TILE`` query heads
of one KV head, so a KV head's rows are read once a tile
(:func:`head_tiles`: twice at recurrentgemma-9b's group of 16).

The launch is the custom op ``torch.ops.repro_torch.decode_attention``
(CUDA only).  Its fake implementation gives a ``meta`` call the
kernel's output, and its FLOP formula tells
``torch.utils.flop_counter.FlopCounterMode`` the kernel's work, so the
dry run (``launch/dryrun.py``) traces a decode step through the kernel
on meta tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_VP] * 5 + [_I] * 5 + [_LL] * 4 + [ctypes.c_float, _I, _I, _I,
                                                _VP]
_OCC_ARGTYPES = [_I] * 7 + [ctypes.POINTER(_I)]
HEAD_DIMS = (16, 32, 64, 128, 256)
GROUP_TILE = 8                  # query heads of one CTA (kMaxGroup)
MAX_GRID_Y = 65535              # KV heads x head tiles
SPLITS = (1, 2, 4, 8)           # cluster sizes (8 is the portable most)
STEP_BYTES = 2048               # K bytes of one KV head in a tile
# num_splits: at most one wave of CTAs (five of the tensor-core kernel's
# fit a SM at D = 64; four is the CUDA-core kernel's), and rows enough a
# split to amortise its merge
MAX_CTAS_PER_SM = 4
MIN_SPLIT_ROWS = 2048
# (q, k/v) dtype pairs: one dtype, or float32 q against the bfloat16 cache
# that the int8-KV path loads
_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.bfloat16))
_SM_COUNT: Dict[int, int] = {}


def tensor_cores(q_dtype, kv_dtype) -> bool:
    """Whether the kernel runs its products on the tensor cores: bfloat16
    q and KV (float32 stays on the CUDA cores, where TF32 would not hold
    the float32 tolerance)."""
    return q_dtype == kv_dtype == torch.bfloat16


def tile_rows(d: int, kv_bytes: int, mma: bool) -> int:
    """Rows of one tile, the unit the kernel splits S by and a warp folds
    at a time: ``STEP_BYTES`` of K per KV head, and at least 16 rows (one
    product's depth) on the tensor cores (``mma``)."""
    rows = STEP_BYTES // (d * kv_bytes)
    return max(rows, 16) if mma else rows


def head_tiles(g: int) -> int:
    """Head tiles (CTAs of at most ``GROUP_TILE`` query heads) of one KV
    head at group ``g``."""
    return -(-g // GROUP_TILE)


def num_splits(b: int, hkv: int, s: int, rows: int, sm_count: int) -> int:
    """CTAs per (batch row, head tile), from shapes and the SM count only (a
    row's split past its length reads nothing, so ``lengths`` is never
    read): double from 1 while the CTAs do not cover the SMs once; past
    that, double while the CTAs stay within ``MAX_CTAS_PER_SM`` a SM (one
    wave) and each split keeps at least ``MIN_SPLIT_ROWS`` rows of the
    capacity ``s`` (more, shorter CTAs even out rows of unequal length,
    but each adds a partial to merge).  Never above 8 (the portable
    cluster) or the tiles (of ``rows``, :func:`tile_rows`) of ``s``, so
    no split is empty by capacity.  ``hkv`` counts the head tiles of every
    KV head (``hkv * head_tiles(g)``): each is a cluster of its own."""
    tiles = -(-s // rows)
    splits = 1
    while splits < SPLITS[-1] and 2 * splits <= tiles:
        ctas = b * hkv * splits
        if ctas >= sm_count and (2 * ctas > MAX_CTAS_PER_SM * sm_count
                                 or s // (2 * splits) < MIN_SPLIT_ROWS):
            break
        splits *= 2
    return splits


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _lib():
    return _build.function("decode_attention_launch", _ARGTYPES)


def max_active_clusters(b: int, hkv: int, g: int, d: int, q_dtype,
                        kv_dtype, splits: int) -> int:
    """Clusters of ``splits`` CTAs the card holds at once for this
    instantiation (``cudaOccupancyMaxActiveClusters``)."""
    fn = _build.function("decode_attention_max_clusters", _OCC_ARGTYPES)
    out = _I(0)
    _build.check(fn(b, hkv, g, d, int(q_dtype == torch.bfloat16),
                    int(kv_dtype == torch.bfloat16), splits,
                    ctypes.byref(out)), "decode_attention occupancy")
    return out.value


class _DecodeAttention:
    """Callable kernel wrapper: checks the arguments and calls the custom
    op.  ``launches`` counts kernel launches, added where the op's CUDA
    implementation launches (a CUDA-graph replay adds the launches
    recorded at its capture: ``_graph.Graph.replay``)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor,
                 splits: Optional[int] = None) -> torch.Tensor:
        """q [B,Hq,D] contiguous, Hq any multiple of Hkv; k, v
        [B,S,Hkv,D] read in place (any batch and sequence strides; each
        row of one head contiguous and 16-byte aligned); lengths [B]
        int32; all on one CUDA device (or all ``meta``: the op's fake
        output, nothing launched).
        q and k/v of one dtype (float32 or bfloat16), or a float32 q with
        bfloat16 k/v.  ``splits`` (1, 2, 4 or 8, at most the tiles of S)
        overrides :func:`num_splits`, for measurement.  Returns
        [B,Hq,D] in V's dtype; a row with length 0 gives 0."""
        if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
            raise ValueError("decode_attention takes q [B,Hq,D] and k, v "
                             f"[B,S,Hkv,D]; got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        b, hq, d = q.shape
        _, s, hkv, dk = k.shape
        if k.shape[0] != b or dk != d or lengths.shape != (b,):
            raise ValueError("decode_attention: shapes disagree: q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                             f"lengths {tuple(lengths.shape)}")
        if d not in HEAD_DIMS:
            raise ValueError(f"decode_attention: head_dim {d} not in "
                             f"{HEAD_DIMS}")
        if hkv < 1 or hq % hkv or hq == 0:
            raise ValueError(f"decode_attention: {hq} query heads over "
                             f"{hkv} KV heads; the query heads must be a "
                             "multiple of the KV heads")
        g = hq // hkv
        if hkv * head_tiles(g) > MAX_GRID_Y:
            raise ValueError(f"decode_attention: {hkv} KV heads x "
                             f"{head_tiles(g)} head tiles above the grid's "
                             f"{MAX_GRID_Y}")
        if (q.dtype, k.dtype) not in _DTYPES or v.dtype != k.dtype:
            raise ValueError("decode_attention takes q and k/v of one "
                             "dtype (float32 or bfloat16), or a float32 q "
                             f"with bfloat16 k/v; got dtypes {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
        if lengths.dtype != torch.int32:
            raise ValueError("decode_attention: lengths must be int32")
        tensors = (q, k, v, lengths)
        if any(not (x.is_cuda or x.is_meta) or x.device != q.device
               for x in tensors):
            raise ValueError("decode_attention runs on CUDA tensors of one "
                             "device (or meta tensors, traced)")
        if not q.is_contiguous() or not lengths.is_contiguous():
            raise ValueError("decode_attention takes contiguous q and "
                             "lengths")
        vec = 16 // k.element_size()
        for name, x in (("k", k), ("v", v)):
            if x.stride(3) != 1 or x.stride(2) != d \
                    or x.stride(0) % vec or x.stride(1) % vec \
                    or x.data_ptr() % 16:
                raise ValueError(f"decode_attention: {name} rows must be "
                                 "contiguous [Hkv, D] blocks at 16-byte "
                                 f"aligned offsets; strides {x.stride()}")
        if splits is not None:
            tiles = -(-s // tile_rows(d, k.element_size(),
                                      tensor_cores(q.dtype, k.dtype)))
            if splits not in SPLITS or splits > max(tiles, 1):
                raise ValueError(f"decode_attention: splits {splits} not "
                                 f"in {SPLITS} or above the {tiles} tiles "
                                 "of S")
        return torch.ops.repro_torch.decode_attention(q, k, v, lengths,
                                                      splits or 0)


decode_attention = _DecodeAttention()


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, splits: int) -> torch.Tensor:
    """One kernel launch on arguments :class:`_DecodeAttention` checked;
    ``splits`` 0 takes :func:`num_splits`'s."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    if not splits:
        rows = tile_rows(d, k.element_size(), tensor_cores(q.dtype,
                                                           k.dtype))
        splits = num_splits(b, hkv * head_tiles(g), s, rows,
                            sm_count(q.device))
    fn = _lib()
    out = torch.empty((b, hq, d), device=q.device, dtype=v.dtype)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), b, s, hkv,
                g, d, k.stride(0), k.stride(1), v.stride(0),
                v.stride(1), math.log2(math.e) * d ** -0.5,
                int(q.dtype == torch.bfloat16),
                int(k.dtype == torch.bfloat16), splits, stream)
    _build.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


@_launch.register_fake
def _(q, k, v, lengths, splits):
    return q.new_empty(q.shape, dtype=v.dtype)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
    """The kernel's products, every row of the cache (a trace does not
    read ``lengths``): 2 * B * Hq * S * (Dk + Dv)."""
    b, hq, dk = q_shape
    return 2 * b * hq * k_shape[1] * (dk + v_shape[3])
