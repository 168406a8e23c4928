"""Wrapper of the hand-written GQA decode-attention kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``.
The plain version of the same function is ``ref.decode_attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_VP] * 5 + [_I] * 5 + [_LL] * 4 + [ctypes.c_float, _I, _I,
                                                _VP]
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
# (q, k/v) dtype pairs: one dtype, or float32 q against the bfloat16 cache
# that the int8-KV path loads
_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.bfloat16))


def _lib():
    return _build.function("decode_attention_launch", _ARGTYPES)


class _DecodeAttention:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
        """q [B,Hq,D] contiguous; k, v [B,S,Hkv,D] read in place (any
        batch and sequence strides; each row of one head contiguous and
        16-byte aligned); lengths [B] int32; all on one CUDA device.
        q and k/v of one dtype (float32 or bfloat16), or a float32 q with
        bfloat16 k/v.  Returns
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
        if hq % hkv or not 1 <= hq // hkv <= MAX_GROUP:
            raise ValueError(f"decode_attention: {hq} query heads over "
                             f"{hkv} KV heads; the group must be 1..."
                             f"{MAX_GROUP}")
        if (q.dtype, k.dtype) not in _DTYPES or v.dtype != k.dtype:
            raise ValueError("decode_attention takes q and k/v of one "
                             "dtype (float32 or bfloat16), or a float32 q "
                             f"with bfloat16 k/v; got dtypes {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
        if lengths.dtype != torch.int32:
            raise ValueError("decode_attention: lengths must be int32")
        tensors = (q, k, v, lengths)
        if any(not x.is_cuda or x.device != q.device for x in tensors):
            raise ValueError("decode_attention runs on CUDA tensors of one "
                             "device")
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
        fn = _lib()
        out = torch.empty((b, hq, d), device=q.device, dtype=v.dtype)
        if b == 0 or hkv == 0:
            return out
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), b, s, hkv,
                    hq // hkv, d, k.stride(0), k.stride(1), v.stride(0),
                    v.stride(1), d ** -0.5, int(q.dtype == torch.bfloat16),
                    int(k.dtype == torch.bfloat16), stream)
        _build.check(status, "decode_attention")
        self.launches += 1
        return out


decode_attention = _DecodeAttention()
