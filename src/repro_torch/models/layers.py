"""Shared model layers: norms, RoPE, embeddings, attention, GLU MLP, MoE,
the cross-entropy.

Port of ``repro/models/layers.py``.  Functions take the reference's flat
parameter dict and keys, so parity stays key for key.

Attention implementations (selected by ``cfg.attention_impl``):

- ``naive``    — full [Sq,Skv] score matrix. Oracle for tests.
- ``chunked``  — flash-style loops over (q-chunk, kv-chunk) pairs with an
                 online softmax; computes every block (the causal upper
                 half masked).
- ``bands``    — triangular band decomposition: band b computes blocks
                 (i, i-b) for all i>=b as one batched einsum, flash merge
                 across bands (the square causal layout); other layouts
                 take the kv-block loop ``_xblock_attention``.

Decode attention (one new token against the cache) dispatches on
``backend``: ``"cuda"`` runs the hand-written kernel, ``"ref"`` the
model's own einsum path below.

Softmax math runs in float32.  Where the reference asks an einsum of
bfloat16 operands for a float32 result (``preferred_element_type``), the
operands are cast to float32 first: a product of two bfloat16 values is
exact in float32, so only the order of the float32 sums differs.

Gradients.  Every function here differentiates under autograd (the
counterpart of ``jax.value_and_grad`` over the reference's ``jnp``
code).  The serving paths write their flash-attention state and scores
in place to hold their memory; where the inputs require gradients the
same operations run out of place, in the same order, so the forward
values are the same bits either way (``_tracked``).  Row gathers whose
rows repeat (the embedding lookup, the MoE dispatch) go through
``gather_rows``, whose backward on CUDA is deterministic, so a captured
train step and the eager one give the same bits.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import on_card, resolve_backend
from repro_torch.kernels.decode_attention.kernel import decode_attention \
    as attn_kernel
from repro_torch.models.param import Registrar, shard

F32 = torch.float32
BF16 = torch.bfloat16


def _promote(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Cast operands to their common dtype, as JAX's einsum promotes
    (bfloat16 with float32 gives float32)."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return tuple(x.to(dt) for x in xs)


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *_promote(*xs))


def _tracked(*xs: torch.Tensor) -> bool:
    """Whether autograd records ops on ``xs``: the gradient path, which
    runs out of place what serving writes in place."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the leading axis (x [N, d], idx [...] int64 ->
    [..., d]): the same gather as ``index_select``, whose backward on
    CUDA adds repeated rows with atomics in no fixed order; the
    embedding's backward (``F.embedding``) sorts the indices and sums
    each row's gradients in one order."""
    return F.embedding(idx, x)


# ---------------------------------------------------------------------------
# Norms / RoPE / embeddings
# ---------------------------------------------------------------------------


def init_rmsnorm(reg: Registrar, path: str, dim: int) -> None:
    reg.param(f"{path}/scale", (dim,), ("embed",), init="ones", dtype=F32)


def rmsnorm(params: Dict, path: str, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_1d(params[f"{path}/scale"], x, eps)


def rmsnorm_1d(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the trailing dim in float32 (also qwen3's per-head
    qk-norm)."""
    dt = x.dtype
    x = x.to(F32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Split-half rotary embedding. x [..., S, ..., D]; positions [..., S].
    Computed in float32, cast back to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.arange(half, dtype=F32, device=x.device)
    inv = theta ** (-freq / half)                        # [half]
    ang = positions.to(F32)[..., None] * inv             # [..., S, half]
    for _ in range(x.dim() - ang.dim() - 1):
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_embedding(reg: Registrar, path: str, vocab: int, dim: int) -> None:
    reg.param(f"{path}/table", (vocab, dim), ("vocab", "embed"),
              init="normal", scale=0.02)


def embed(params: Dict, path: str, ids: torch.Tensor) -> torch.Tensor:
    rows = gather_rows(params[f"{path}/table"], ids)
    s = params.get(f"{path}/table_scale")
    if s is not None:  # int8 serving table: dequantize the gathered rows
        rows = rows.to(BF16) * s.to(BF16)
    return rows


def W(params: Dict, key: str) -> torch.Tensor:
    """Fetch a matmul weight, dequantizing int8 serving weights on the
    fly (a per-tensor scale, per-layer for stacked weights)."""
    w = params[key]
    s = params.get(f"{key}_scale")
    if s is not None:
        w = w.to(BF16) * s.to(BF16)
    return w


class _MatmulF32(torch.autograd.Function):
    """a [m, k] @ b [k, n], bfloat16 operands, float32 result, on the
    card: a GEMM with float32 output (``torch.mm(out_dtype=)``, which has
    no derivative of its own).  The backward is the derivative of the
    CPU path's ``a.float() @ b.float()``: float32 products of the float32
    cotangent, cast to the operands' dtype, each laid out as autograd's
    ``mm`` backward lays it out (a column-major operand's gradient is
    computed transposed), so its bits are the cast path's.  For
    llama3.2-1b's tied head (2048 x 128256) at 2 x 4096 tokens those
    are two float32 GEMMs of 4.3e12 operations each, 0.13 s at the
    card's 67 TFLOP/s of float32 outside the tensor cores, and a float32
    copy of the table (1.05 GB)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        a32, b32 = a.to(F32), b.to(F32)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (b32.mm(g.t()).t() if _column_major(a32)
                  else g.mm(b32.t())).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (g.t().mm(a32).t() if _column_major(b32)
                  else a32.t().mm(g)).to(b.dtype)
        return ga, gb


def _column_major(x: torch.Tensor) -> bool:
    return x.stride(0) == 1 and x.stride(1) == x.shape[0]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ b [k, n] with a float32 result: the products are exact
    and summed in float32 (JAX's ``preferred_element_type=F32``).  On the
    card bfloat16 operands go to a GEMM with float32 output, so a large
    weight is not copied to float32 first (``_MatmulF32``: its backward
    is the cast path's; a ``meta`` trace of the card's path takes it
    too); elsewhere they are cast."""
    if on_card(a) and a.dtype == b.dtype == BF16:
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.to(F32), b.to(F32))


def logits_head(params: Dict, x: torch.Tensor, head_path: Optional[str],
                embed_path: str) -> torch.Tensor:
    """x [..., d] -> float32 [..., V]; the tied variant reuses the
    embedding table."""
    if head_path is not None:
        return matmul_f32(x, W(params, f"{head_path}/w"))       # [d, V]
    return matmul_f32(x, W(params, f"{embed_path}/table").t())  # [V, d]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy, float32-stable: logits [..., V], labels int
    [...]; with ``mask`` [...] the mean over its weight (at least 1)."""
    logits = logits.to(F32)
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def _pad_to(x: torch.Tensor, axis: int, mult: int
            ) -> Tuple[torch.Tensor, int]:
    s = x.shape[axis]
    pad = (-s) % mult
    if pad == 0:
        return x, 0
    widths = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [0, pad]
    return F.pad(x, widths), pad


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              impl: str = "bands",
              chunk_q: int = 1024,
              chunk_kv: int = 1024,
              window: Optional[int] = None,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Sq,Hq,Dk]; k [B,Skv,Hkv,Dk]; v [B,Skv,Hkv,Dv] -> [B,Sq,Hq,Dv]."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    dev = q.device
    if impl == "naive":
        qg = q.reshape(b, sq, hkv, hq // hkv, dk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32), k.to(F32)) * scale
        qpos = torch.arange(sq, device=dev)[:, None] \
            + (skv - sq if causal else 0)
        kpos = torch.arange(skv, device=dev)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        if kv_len is not None:
            mask = mask[None] & (kpos[None] < kv_len[:, None, None])
            s = torch.where(mask[:, None, None], s, -torch.inf)
        else:
            s = torch.where(mask, s, -torch.inf)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhe->bqhge", p.to(v.dtype), v)
        return o.reshape(b, sq, hq, dv)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal=causal, chunk_q=chunk_q,
                                  chunk_kv=chunk_kv, window=window,
                                  kv_len=kv_len, scale=scale)
    if impl == "bands":
        if not causal or sq != skv:
            # bands requires the square causal layout; use the kv-block loop
            return _xblock_attention(q, k, v, causal=causal,
                                     chunk_kv=chunk_kv, window=window,
                                     kv_len=kv_len, scale=scale)
        return _band_attention(q, k, v, chunk=chunk_q, window=window,
                               scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


def _scores(s, scale, keep):
    """Float32 scores ``s`` (an einsum's output) times ``scale``, -inf
    where ``keep`` (broadcast) is false: in place when serving; out of
    place under autograd, where an in-place op on the einsum's output
    view would have the backward copy the whole score tensor."""
    if _tracked(s):
        return torch.where(keep, s * scale, -torch.inf)
    return s.mul_(scale).masked_fill_(~keep, -torch.inf)


def _merge(m, lse, s, v_dtype):
    """One flash step over masked float32 scores ``s`` (-inf where masked;
    overwritten by p unless autograd records ``s``): returns (m_new,
    lse_new, corr, p in ``v_dtype``).  The reference zeroes p where s is
    -inf; exp(-inf) is 0 already."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
    if _tracked(s):
        p = torch.exp(s - m_safe[..., None])
    else:
        p = s.sub_(m_safe[..., None]).exp_()
    m_inf = torch.isinf(m)
    corr = torch.exp(torch.where(m_inf, 0.0, m) - m_safe)
    corr = torch.where(m_inf, 0.0, corr)
    lse = lse * corr + p.sum(dim=-1)
    return m_new, lse, corr, p.to(v_dtype)


def _xblock_attention(q, k, v, *, causal, chunk_kv, window, kv_len, scale):
    """Flash merge over an unrolled Python loop of KV chunks (cross /
    encoder attention and non-square layouts)."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    dev = q.device
    ck = min(chunk_kv, skv)
    k, _ = _pad_to(k, 1, ck)
    v, _ = _pad_to(v, 1, ck)
    nk = k.shape[1] // ck
    qg = q.reshape(b, sq, hkv, g, dk).to(F32)
    qpos = torch.arange(sq, device=dev)[:, None] + (skv - sq if causal else 0)
    m = torch.full((b, hkv, g, sq), -torch.inf, dtype=F32, device=dev)
    lse = torch.zeros((b, hkv, g, sq), dtype=F32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=F32, device=dev)
    for ki in range(nk):
        kb = k[:, ki * ck:(ki + 1) * ck]
        vb = v[:, ki * ck:(ki + 1) * ck]
        kpos = ki * ck + torch.arange(ck, device=dev)
        msk = ((kpos < skv)[None, :]).expand(sq, ck)
        if causal:
            msk = msk & (kpos[None, :] <= qpos)
        if window is not None:
            msk = msk & ((qpos - kpos[None, :]) < window)
        if kv_len is not None:
            msk = (msk[None] & (kpos[None, None, :]
                                < kv_len[:, None, None]))[:, None, None]
        s = _scores(torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.to(F32)),
                    scale, msk)
        m, lse, corr, p = _merge(m, lse, s, v.dtype)
        acc = acc * corr[..., None] \
            + torch.einsum("bhgqk,bkhe->bhgqe", p, vb).to(F32)
    out = acc / torch.clamp_min(lse, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(v.dtype)


def _chunked_attention(q, k, v, *, causal, chunk_q, chunk_kv, window, kv_len,
                       scale):
    """Flash attention over (q-chunk, kv-chunk) pairs with an online
    softmax: the reference's two nested ``lax.scan``s as Python loops.
    Every block is computed (the causal upper half too, masked); padded
    keys are masked by the key count (``kv_len``, else Skv)."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    dev = q.device
    cq = min(chunk_q, sq)
    ck = min(chunk_kv, skv)
    q, _ = _pad_to(q, 1, cq)
    k, _ = _pad_to(k, 1, ck)
    v, _ = _pad_to(v, 1, ck)
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    q_r = q.reshape(b, nq, cq, hkv, g, dk).to(F32)
    k_r = k.reshape(b, nk, ck, hkv, dk).to(F32)
    v_r = v.reshape(b, nk, ck, hkv, dv)
    off = skv - sq if causal else 0
    eff_len = kv_len if kv_len is not None else torch.full(
        (b,), skv, device=dev)
    outs = []
    for qi in range(nq):
        qpos = qi * cq + torch.arange(cq, device=dev) + off        # [cq]
        m = torch.full((b, hkv, g, cq), -torch.inf, dtype=F32, device=dev)
        lse = torch.zeros((b, hkv, g, cq), dtype=F32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, dv), dtype=F32, device=dev)
        for ki in range(nk):
            kpos = ki * ck + torch.arange(ck, device=dev)
            msk = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                msk &= (qpos[:, None] - kpos[None, :]) < window
            msk = msk[None] & (kpos[None, None, :] < eff_len[:, None, None])
            s = _scores(torch.einsum("bqhgd,bkhd->bhgqk", q_r[:, qi],
                                     k_r[:, ki]), scale, msk[:, None, None])
            m, lse, corr, p = _merge(m, lse, s, v.dtype)
            acc = acc * corr[..., None] \
                + torch.einsum("bhgqk,bkhe->bhgqe", p, v_r[:, ki]).to(F32)
        outs.append(acc / torch.clamp_min(lse, 1e-30)[..., None])
    # [nq][B, hkv, g, cq, dv] -> [B, nq * cq, Hq, dv]
    out = torch.stack(outs, 1).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(b, nq * cq, hq, dv)[:, :sq].to(v.dtype)


# the most bytes the first band's float32 scores [B, n, Hq, c, c] may
# take: past it the batch runs a slice of sequences at a time (they are
# independent, so the values are the same).  deepseek-v2-236b's 128 heads
# at batch 8 x 4096 tokens would take 17.2 GB (and 8.6 GB of bf16 p);
# llama3.2-1b's and llama-3.2-vision-11b's 32 heads take 4 GiB, whole
BAND_BYTES = 1 << 32


def _band_attention(q, k, v, *, chunk, window, scale):
    b, s, hq, dk = q.shape
    c = min(chunk, s)
    per_seq = -(-s // c) * hq * c * c * 4
    if b > 1 and b * per_seq > BAND_BYTES:
        step = max(1, BAND_BYTES // per_seq)
        return torch.cat([_band_attention(q[i:i + step], k[i:i + step],
                                          v[i:i + step], chunk=chunk,
                                          window=window, scale=scale)
                          for i in range(0, b, step)])
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    dev = q.device
    q, pad = _pad_to(q, 1, c)
    k, _ = _pad_to(k, 1, c)
    v, _ = _pad_to(v, 1, c)
    sp = q.shape[1]
    n = sp // c
    q_r = q.reshape(b, n, c, hkv, g, dk).to(F32)
    k_r = k.reshape(b, n, c, hkv, dk).to(F32)
    v_r = v.reshape(b, n, c, hkv, dv)
    # band b touches offsets [b*c-(c-1), b*c+(c-1)]; include every band
    # whose minimum offset is still inside the window
    n_bands = n if window is None else min(n, (window + c - 2) // c + 1)

    m = torch.full((b, n, hkv, g, c), -torch.inf, dtype=F32, device=dev)
    lse = torch.zeros((b, n, hkv, g, c), dtype=F32, device=dev)
    acc = torch.zeros((b, n, hkv, g, c, dv), dtype=F32, device=dev)
    qi_in = torch.arange(c, device=dev)[:, None]
    ki_in = torch.arange(c, device=dev)[None, :]
    valid_k = torch.arange(sp, device=dev) < s             # kv padding mask
    # the bands' updates of m, lse and acc: in place when serving, new
    # tensors (the untouched first blocks and the band's rows) under
    # autograd, which saves the old rows
    tracked = _tracked(q, k, v)

    def put(t, band, rows):
        if tracked:
            return torch.cat([t[:, :band], rows], dim=1)
        t[:, band:] = rows
        return t

    for band in range(n_bands):
        nb = n - band
        offs = band * c + qi_in - ki_in                    # [c,c] q-k
        msk = offs >= 0
        if window is not None:
            msk &= offs < window
        kmask = valid_k[:nb * c].reshape(nb, c)            # [nb,c]
        full_mask = msk[None, None, None, None] \
            & kmask[None, :, None, None, None, :]
        sco = _scores(torch.einsum("bnqhgd,bnkhd->bnhgqk", q_r[:, band:],
                                   k_r[:, :nb]), scale, full_mask)
        m_new, lse_new, corr, p = _merge(m[:, band:], lse[:, band:], sco,
                                         v.dtype)
        lse = put(lse, band, lse_new)
        o = torch.einsum("bnhgqk,bnkhe->bnhgqe", p, v_r[:, :nb])
        acc = put(acc, band, acc[:, band:] * corr[..., None] + o.to(F32))
        m = put(m, band, m_new)
        del sco, p, o

    out = acc / torch.clamp_min(lse, 1e-30)[..., None]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, sp, hq, dv)
    return out[:, :s].to(v.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Single-token attention. q [B,Hq,Dk]; caches [B,Smax,Hkv,D*];
    lengths [B] -> [B,Hq,Dv] in the cache's dtype.

    ``backend="cuda"`` (the default for CUDA tensors) runs the
    hand-written kernel (``kernels/decode_attention``; ``lengths`` int32):
    the counterpart of the reference's ``ops.set_backend`` switch.  Its
    probabilities stay float32 through the value sum.  ``"ref"`` (the
    default on the CPU) is the model's own path: ``p`` is cast to the
    cache dtype before the value product, as the reference does.  A
    ``window`` runs on ``"ref"`` only (the hybrid family's decode reads a
    ring of window slots and passes none).
    """
    if resolve_backend(backend, q, "attn_backend") == "cuda":
        if window is not None:
            raise NotImplementedError(
                "windowed decode attention has no kernel (no reference "
                "model passes a window: the hybrid family's ring cache "
                "holds only the window); use attn_backend='ref'")
        return attn_kernel(q, k_cache, v_cache, lengths)
    b, hq, dk = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    qg = q.reshape(b, hkv, hq // hkv, dk)
    k_cache = shard(k_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    v_cache = shard(v_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    s = torch.einsum("bhgd,bshd->bhgs", qg.to(F32), k_cache.to(F32)) \
        * (dk ** -0.5)
    kpos = torch.arange(smax, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if window is not None:
        mask &= kpos > (lengths[:, None] - 1 - window)
    s = torch.where(mask[:, None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshe->bhge", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, dv)


# ---------------------------------------------------------------------------
# Dense projections / MLP
# ---------------------------------------------------------------------------


def init_dense(reg: Registrar, path: str, shape, axes, bias: bool = False,
               bias_axes=None, scale: Optional[float] = None) -> None:
    """Register ``{path}/w`` (``"normal"`` at ``scale``) and, with
    ``bias``, ``{path}/b`` (``"zeros"``): the trailing dims of ``shape``
    that ``bias_axes`` names, else the last one."""
    reg.param(f"{path}/w", shape, axes, init="normal", scale=scale)
    if bias:
        bshape = (tuple(shape[len(shape) - len(bias_axes):]) if bias_axes
                  else (shape[-1],))
        reg.param(f"{path}/b", bshape, bias_axes or (axes[-1],),
                  init="zeros")


def dense(params: Dict, path: str, x: torch.Tensor, eq: str) -> torch.Tensor:
    y = einsum(eq, x, W(params, f"{path}/w"))
    b = params.get(f"{path}/b")
    if b is not None:
        y = y + b
    return y


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` op for op in x's dtype: 1 / (1 + exp(-x)), each
    op rounded (``torch.sigmoid`` rounds once and differs from JAX in a
    third of bfloat16 outputs)."""
    return torch.reciprocal(1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` op for op: ``jnp.logaddexp(x, 0)``, that is
    max(x, 0) + log1p(exp(-|x|)), and x where x is NaN.  (``F.softplus``
    returns x itself above its threshold of 20 and rounds otherwise.)"""
    return torch.where(torch.isnan(x), x, torch.clamp_min(x, 0)
                       + torch.log1p(torch.exp(-x.abs())))


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """JAX's activations op for op in x's dtype, each op rounded as
    JAX rounds it (``torch.sigmoid`` / ``F.gelu`` round once at the end
    and differ from JAX in a third of bfloat16 outputs)."""
    if name == "silu":
        # jax.nn.silu: x * sigmoid(x)
        return x * sigmoid(x)
    if name == "gelu":
        # jax.nn.gelu(approximate=True), sqrt(2/pi) rounded to x's dtype
        c = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    raise ValueError(name)


def init_glu_mlp(reg: Registrar, path: str, d: int, f: int,
                 stack: Tuple[int, ...] = ()) -> None:
    sa = tuple("stack" for _ in stack)
    reg.param(f"{path}/wi_gate", (*stack, d, f), (*sa, "embed", "ffn"),
              init="normal", scale=d ** -0.5)
    reg.param(f"{path}/wi_up", (*stack, d, f), (*sa, "embed", "ffn"),
              init="normal", scale=d ** -0.5)
    reg.param(f"{path}/wo", (*stack, f, d), (*sa, "ffn", "embed"),
              init="normal", scale=f ** -0.5)


def glu_mlp(params: Dict, path: str, x: torch.Tensor,
            act: str) -> torch.Tensor:
    g = einsum("...d,df->...f", x, W(params, f"{path}/wi_gate"))
    u = einsum("...d,df->...f", x, W(params, f"{path}/wi_up"))
    h = _act(act, g) * u
    return einsum("...f,fd->...d", h, W(params, f"{path}/wo"))


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based capacity dispatch)
# ---------------------------------------------------------------------------


def init_moe(reg: Registrar, path: str, d: int, moe) -> None:
    e, f = moe.num_experts, moe.expert_d_ff
    reg.param(f"{path}/router/w", (d, e), ("embed", "experts"),
              init="normal", scale=d ** -0.5, dtype=F32)
    for nm in ("wi_gate", "wi_up"):
        reg.param(f"{path}/experts/{nm}", (e, d, f),
                  ("experts", "embed", "ffn"), init="normal", scale=d ** -0.5)
    reg.param(f"{path}/experts/wo", (e, f, d), ("experts", "ffn", "embed"),
              init="normal", scale=f ** -0.5)
    if moe.num_shared_experts:
        init_glu_mlp(reg, f"{path}/shared", d, moe.shared_d_ff)
        if moe.shared_gated:
            reg.param(f"{path}/shared_gate/w", (d, 1), ("embed", "classes"),
                      init="normal", scale=d ** -0.5)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    val, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def moe_ffn(params: Dict, path: str, x: torch.Tensor, moe, act: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d], aux_loss scalar float32).

    The reference's sort-based capacity dispatch: each (token, choice)
    pair goes to its expert's next slot in the stable order of the
    flattened choices, an expert keeps its first ``cap`` pairs and the
    rest are dropped (at decode, B tokens give ``cap = max(1, int(1.25 *
    B * k / e))``, 1 for B = 8 on 60 experts).  Nothing is read back to
    the host (no ``bincount``: the counts are a ``scatter_add_``), so a
    decode step with it can be captured as a CUDA graph.  Dropped pairs
    write and read the spare row at ``e * cap`` (the reference's
    ``mode="drop"`` / ``mode="fill"``).  The combine is deterministic:
    each token's k weighted outputs are gathered and added in the order
    the reference's scatter-add applies them (ascending sorted position),
    not by an atomic ``index_add_``.  ``dispatch_chunks`` is ignored: in
    the reference it bounds GSPMD's memory across devices, and on one
    card the dispatch is one ``index_put_`` (the slots are unique, so the
    reference's result is the same for any chunk count).
    """
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    dev = x.device
    xf = x.reshape(t, d)

    logits = einsum("td,de->te", xf.to(F32), params[f"{path}/router/w"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)                         # [t,k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # aux load-balance loss (Switch-style)
    experts = torch.arange(e, device=dev)
    frac_tokens = torch.mean(
        (top_i[..., None] == experts).to(F32).sum(1), dim=0)  # [e]
    frac_probs = torch.mean(probs, dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs) * moe.aux_loss_weight

    cap = max(1, int(moe.capacity_factor * t * k / e))
    flat_e = top_i.reshape(-1)                              # [t*k]
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    token_of = sort_idx // k
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)

    # the dispatch buffer with the spare row the dropped pairs write
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((slot,), gather_rows(xf, token_of))
    buf = buf[:e * cap].reshape(e, cap, d)

    g = einsum("ecd,edf->ecf", buf, W(params, f"{path}/experts/wi_gate"))
    u = einsum("ecd,edf->ecf", buf, W(params, f"{path}/experts/wi_up"))
    h = _act(act, g) * u
    y_e = einsum("ecf,efd->ecd", h, W(params, f"{path}/experts/wo"))

    # combine: the spare row reads 0 (mode="fill"), weights 0 where dropped
    y_flat = torch.cat([y_e.reshape(e * cap, d),
                        y_e.new_zeros((1, d))], dim=0)
    w = torch.where(keep, top_w.reshape(-1)[sort_idx], 0.0)  # [t*k]
    contrib = y_flat.index_select(0, slot) * w[:, None].to(x.dtype)
    # each token's k sorted positions, ascending: the scatter's add order
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(t * k, device=dev)
    order = torch.sort(rank.reshape(t, k), dim=-1).values
    parts = contrib.index_select(0, order.reshape(-1)).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + parts[:, j]

    if moe.num_shared_experts:
        sh = glu_mlp(params, f"{path}/shared", xf, act)
        if moe.shared_gated:
            # the raw weight, as the reference reads it (not W(): int8
            # serving weights enter this product unscaled there too)
            gate = sigmoid(einsum("td,dz->tz", xf,
                                  params[f"{path}/shared_gate/w"]))
            sh = sh * gate.to(x.dtype)
        y = y + sh
    return y.reshape(b, s, d), aux
