"""Plain PyTorch version of single-token GQA decode attention.

Port of ``repro/kernels/decode_attention/ref.py``: scores, softmax and
the value sum in float32, the output cast to V's dtype.  A row with
``lengths == 0`` has no key and gives NaN, as the reference's does (the
kernel gives 0 there, as the TPU kernel does).
``decode_attention_split_ref`` is the kernel's split-and-merge algorithm
written out plainly.
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


def split_bounds(s: int, splits: int, rows: int):
    """Row ranges [lo, hi) of the kernel's splits: split c owns the whole
    tiles [c*T/splits, (c+1)*T/splits) of the T = ceil(s / rows) tiles of
    the capacity, clipped at s."""
    tiles = -(-s // rows)
    return [(min(s, c * tiles // splits * rows),
             min(s, (c + 1) * tiles // splits * rows))
            for c in range(splits)]


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor,
                               splits: int, rows: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: each split's float32
    partial (m, l, acc) over its rows below ``lengths`` (a split wholly
    past a row's length gives (-inf, 0, 0)), merged in split order with
    the TPU kernel's isinf guards; out = acc / max(l, 1e-30), so an empty
    row gives 0, as the kernels do.  Shapes as ``decode_attention_ref``;
    ``rows`` is the tile (``kernel.tile_rows``)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).to(F32)
    dev = k.device
    lens = lengths.to(dev)[:, None]
    parts = []
    for lo, hi in split_bounds(k.shape[1], splits, rows):
        if hi == lo:
            parts.append((torch.full((b, hkv, g), -torch.inf, device=dev),
                          torch.zeros(b, hkv, g, device=dev),
                          torch.zeros(b, hkv, g, d, device=dev)))
            continue
        sc = torch.einsum("bhgd,bshd->bhgs", qg, k[:, lo:hi].to(F32))
        sc = sc * (d ** -0.5)
        mask = torch.arange(lo, hi, device=dev)[None, :] < lens
        sc = torch.where(mask[:, None, None], sc, -torch.inf)
        m = sc.amax(dim=-1)
        m_safe = torch.where(torch.isinf(m), 0.0, m)
        p = torch.where(torch.isinf(sc), 0.0,
                        torch.exp(sc - m_safe[..., None]))
        acc_c = torch.einsum("bhgs,bshd->bhgd", p, v[:, lo:hi].to(F32))
        parts.append((m, p.sum(dim=-1), acc_c))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    m_safe = torch.where(torch.isinf(m_all), 0.0, m_all)
    l_sum = torch.zeros_like(m_safe)
    acc = torch.zeros(b, hkv, g, d, device=dev)
    for m, l_c, acc_c in parts:
        w = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l_sum = l_sum + w * l_c
        acc = acc + w[..., None] * acc_c
    out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
    return out.reshape(b, hq, d).to(v.dtype)
