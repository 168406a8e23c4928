"""Plain PyTorch version of single-token GQA decode attention.

Port of ``repro/kernels/decode_attention/ref.py``: scores, softmax and
the value sum in float32, the output cast to V's dtype.  A row with
``lengths == 0`` has no key and gives NaN, as the reference's does (the
kernel gives 0 there, as the TPU kernel does).
"""

from __future__ import annotations

import torch

F32 = torch.float32


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q [B,Hq,D]; k,v [B,S,Hkv,D]; lengths [B] -> out [B,Hq,D]."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.to(F32), k.to(F32))
    scores = scores * (d ** -0.5)
    mask = torch.arange(s, device=k.device)[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, None], scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(F32))
    return out.reshape(b, hq, d).to(v.dtype)
