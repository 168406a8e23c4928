"""Mamba2 (SSD, state-space duality) LM: attention-free, sub-quadratic.

Port of ``repro/models/mamba2.py``: ``loss_fn`` (``forward_train``,
each block under the transformer's ``_remat``), ``prefill``,
``decode_step`` and ``cache_spec``.  Chunked
SSD algorithm (Dao & Gu 2024, arXiv:2405.21060): the within-chunk
quadratic term (the diagonal blocks of the semiseparable matrix) plus
the inter-chunk low-rank term carried by a sequential scan over chunk
states.

Prefill cost O(S * Q), attention-free; decode an O(1) state update.
Serving writes the SSD's transients and the inter-chunk states in place
(the long_500k prefill's memory); under autograd ``_ssd_chunked`` runs
the same operations out of place, so its values are the same bits.
The decode cache per layer is a conv tail [B, d_conv-1, conv_dim] and an
SSM state [B, G, R, P, N] (float32), stacked over layers under
``"scan/conv"`` / ``"scan/h"``, and ``"pos"``, a 0-d int32 device
tensor.  ``decode_step`` writes each layer's new conv tail and state
into those tensors in place and reads nothing back to the host, so a
CUDA graph can replay it (the engine's warm-up before capture runs on
copies of them: entries without a ``kv_seq`` axis are state that a step
overwrites).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import Registrar, maybe_scan, subtree
from repro_torch.models.transformer import _remat, _Stacked

F32 = torch.float32

# the most bytes one float32 [B, chunks, G, R, Q, Q] tensor of the
# diagonal term may take: the chunks are taken that many at a time
# (8 x 4096 tokens at full width: 1.07 GB for all 16 chunks at once,
# 17.2 GB at long_500k)
DIAG_BYTES = 1 << 30
# a prefill longer than this many tokens (rounded down to whole chunks)
# runs each layer over segments of that length, carrying the conv tail
# and the SSM state from one to the next: the same chunks, the same scan,
# so the same values, with a block's transients (~60 bytes a token and
# channel of d_model) held for one segment at a time (long_500k's
# 524288 tokens would hold ~30 GB)
PREFILL_SEGMENT = 1 << 16


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_dim


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(reg, cfg: ModelConfig) -> None:
    d = cfg.d_model
    s = cfg.ssm
    d_in, h, conv_dim = _dims(cfg)
    gn = s.n_groups * s.d_state
    L.init_rmsnorm(reg, "ln", d)
    reg.param("wz/w", (d, d_in), ("embed", "ssm_inner"), scale=d ** -0.5)
    reg.param("wx/w", (d, d_in), ("embed", "ssm_inner"), scale=d ** -0.5)
    reg.param("wb/w", (d, gn), ("embed", "state"), scale=d ** -0.5)
    reg.param("wc/w", (d, gn), ("embed", "state"), scale=d ** -0.5)
    reg.param("wdt/w", (d, h), ("embed", "ssm_heads"), scale=d ** -0.5)
    reg.param("conv/w", (s.d_conv, conv_dim), ("conv", "ssm_inner"),
              init="normal", scale=s.d_conv ** -0.5)
    reg.param("conv/b", (conv_dim,), ("ssm_inner",), init="zeros")
    reg.param("A_log", (h,), ("ssm_heads",), init="uniform", scale=1.0,
              dtype=F32)
    reg.param("D", (h,), ("ssm_heads",), init="ones", dtype=F32)
    reg.param("dt_bias", (h,), ("ssm_heads",), init="zeros", dtype=F32)
    reg.param("gnorm/scale", (d_in,), ("ssm_inner",), init="ones", dtype=F32)
    reg.param("wo/w", (d_in, d), ("ssm_inner", "embed"), scale=d_in ** -0.5)


def init_params(reg: Registrar, cfg: ModelConfig) -> None:
    L.init_embedding(reg, "embed", cfg.vocab_size, cfg.d_model)
    _init_block(_Stacked(reg, cfg.num_layers, "layers/"), cfg)
    L.init_rmsnorm(reg, "ln_f", cfg.d_model)
    if not cfg.tie_embeddings:
        reg.param("head/w", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                  scale=cfg.d_model ** -0.5)


# ---------------------------------------------------------------------------
# Core SSD math
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x [B,S,C]; w [K,C]. O(K) shifted adds, in
    the reference's order (each product and sum rounded to x's dtype; an
    int8 serving ``w`` enters raw, as the reference reads it)."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = xp[:, :s] * w[0]
    for j in range(1, k):
        y = y + xp[:, j:j + s] * w[j]
    return y + b


def _ssd_chunked(xdt, dA, b_r, c_r, cfg: ModelConfig, h0=None,
                 diag_chunks: Optional[int] = None):
    """Chunked SSD.

    xdt [B,S,G,R,P] (dt-scaled inputs), dA [B,S,G,R] (log decay),
    b_r/c_r [B,S,G,N].  Returns (y [B,S,G,R,P], h_last [B,G,R,P,N]).

    The diagonal term is computed ``diag_chunks`` chunks at a time (by
    default as many as keep each float32 [B, chunks, G, R, Q, Q] tensor
    within ``DIAG_BYTES``); every element is the same whatever the
    count.  The inter-chunk scan is a loop over the chunks, writing each
    chunk's incoming state into one float32 buffer.  Where autograd
    records the inputs, the same operations run out of place: the
    diagonal slices and the chunk states are new tensors, joined at the
    end.
    """
    tracked = L._tracked(xdt, dA, b_r, c_r)
    bsz, s, g, r, p = xdt.shape
    n = b_r.shape[-1]
    q = min(cfg.ssm.chunk_size, s)
    pad = (-s) % q
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad))
        b_r = F.pad(b_r, (0, 0, 0, 0, 0, pad))
        c_r = F.pad(c_r, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // q
    dev = xdt.device
    xdt = xdt.reshape(bsz, nc, q, g, r, p)
    dA = dA.reshape(bsz, nc, q, g, r)
    b_c = b_r.reshape(bsz, nc, q, g, n)
    c_c = c_r.reshape(bsz, nc, q, g, n)

    a_cs = torch.cumsum(dA, dim=2)                    # [B,nc,Q,G,R]
    # within-chunk (diagonal) term, a slice of chunks at a time
    if diag_chunks is None:
        diag_chunks = max(1, DIAG_BYTES // (4 * bsz * g * r * q * q))
    keep = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    y_diag = [] if tracked else torch.empty_like(xdt)
    for c0 in range(0, nc, diag_chunks):
        cs = slice(c0, c0 + diag_chunks)
        scores = L.einsum("bclgn,bcsgn->bcgls", c_c[:, cs].to(F32),
                          b_c[:, cs].to(F32))         # [B,c,G,Q,Q]
        a = a_cs[:, cs]
        decay = (a[:, :, :, None] - a[:, :, None]).permute(0, 1, 4, 5, 2, 3)
        # [B,c,G,R,Ql,Qs]: exp(decay) on and below the diagonal, else 0,
        # times the scores
        if tracked:
            st = torch.exp(decay).masked_fill(~keep, 0.0) \
                * scores[:, :, :, None]
        else:
            st = decay.exp_().masked_fill_(~keep, 0.0).mul_(
                scores[:, :, :, None])
        yd = torch.einsum("bcgrls,bcsgrp->bclgrp", st.to(xdt.dtype),
                          xdt[:, cs])
        if tracked:
            y_diag.append(yd)
        else:
            y_diag[:, cs] = yd
        del scores, decay, st, yd
    if tracked:
        y_diag = torch.cat(y_diag, dim=1)

    # chunk states
    dstate = torch.exp(a_cs[:, :, -1:] - a_cs)        # [B,nc,Q,G,R]
    xw = xdt * dstate[..., None].to(xdt.dtype)
    states = L.einsum("bcsgn,bcsgrp->bcgrpn", b_c, xw)  # [B,nc,G,R,P,N]
    del xw, dstate

    # inter-chunk sequential scan: hs[c] is the state entering chunk c
    decay_c = torch.exp(a_cs[:, :, -1]).transpose(0, 1)[..., None, None]
    states = states.transpose(0, 1)                   # [nc,B,G,R,P,N]
    if tracked:
        h = torch.zeros((bsz, g, r, p, n), dtype=F32, device=dev) \
            if h0 is None else h0.to(F32)
        hs = [h]
        for c in range(nc):
            h = h * decay_c[c] + states[c]
            hs.append(h)
        h_last, hs = h, torch.stack(hs)
    else:
        hs = torch.empty((nc + 1, bsz, g, r, p, n), dtype=F32, device=dev)
        if h0 is None:
            hs[0].zero_()
        else:
            hs[0].copy_(h0)
        for c in range(nc):
            torch.mul(hs[c], decay_c[c], out=hs[c + 1])
            hs[c + 1].add_(states[c])
        h_last = hs[nc].clone()  # not a view: the caller keeps it, not hs
    del states

    # off-diagonal term, in the reference's contraction order: the states
    # against C (over N), then the decay into the chunk, each rounded to
    # the inputs' dtype
    decay_in = torch.exp(a_cs)                        # [B,nc,Q,G,R]
    y_off = L.einsum("cbgrpn,bclgn->bcgrpl", hs[:nc].to(xdt.dtype), c_c)
    y_off = y_off.permute(0, 1, 5, 2, 3, 4) * decay_in.to(xdt.dtype)[..., None]
    y = (y_diag + y_off).reshape(bsz, sp, g, r, p)[:, :s]
    return y, h_last


def _block_seq(p, cfg: ModelConfig, x, h0=None, conv0=None):
    """Full-sequence block. x [B,S,d] -> (y, (conv_tail, h_last))."""
    s_cfg = cfg.ssm
    d_in, h, conv_dim = _dims(cfg)
    g, r = s_cfg.n_groups, (d_in // s_cfg.head_dim) // s_cfg.n_groups
    pdim, n = s_cfg.head_dim, s_cfg.d_state
    bsz, s, _ = x.shape
    kc = s_cfg.d_conv - 1
    hx = L.rmsnorm(p, "ln", x, cfg.norm_eps)
    z = L.dense(p, "wz", hx, "...d,di->...i")
    xbc = torch.cat([
        L.dense(p, "wx", hx, "...d,di->...i"),
        L.dense(p, "wb", hx, "...d,di->...i"),
        L.dense(p, "wc", hx, "...d,di->...i")], dim=-1)
    if conv0 is not None:
        xbc_in = torch.cat([conv0, xbc], dim=1)
        conv_tail = xbc_in[:, -kc:]
        y = _causal_conv(xbc_in, p["conv/w"], p["conv/b"])[:, -s:]
    else:
        conv_tail = xbc[:, max(0, s - kc):]
        if conv_tail.shape[1] < kc:
            conv_tail = F.pad(conv_tail, (0, 0, kc - conv_tail.shape[1], 0))
        y = _causal_conv(xbc, p["conv/w"], p["conv/b"])
    y = L._act("silu", y)
    xs, bs, cs = torch.split(y, [d_in, g * n, g * n], dim=-1)
    dt = L.softplus(
        L.dense(p, "wdt", hx, "...d,dh->...h").to(F32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])                        # [H]
    dA = (dt * a).reshape(bsz, s, g, r)
    xs = xs.reshape(bsz, s, g, r, pdim)
    xdt = xs * dt.reshape(bsz, s, g, r)[..., None].to(xs.dtype)
    b_r = bs.reshape(bsz, s, g, n)
    c_r = cs.reshape(bsz, s, g, n)
    yss, h_last = _ssd_chunked(xdt, dA, b_r, c_r, cfg, h0=h0)
    yss = yss + xs * p["D"].reshape(g, r)[..., None].to(xs.dtype)
    yf = yss.reshape(bsz, s, d_in)
    yf = L.rmsnorm_1d(p["gnorm/scale"], yf * L._act("silu", z), cfg.norm_eps)
    out = L.dense(p, "wo", yf, "...i,id->...d")
    # the tail a copy (a view would keep the whole xbc alive in the cache)
    return x + out, (conv_tail.clone(), h_last)


def _block_decode(p, cfg: ModelConfig, x, conv_state, h_state):
    """Single-token step. x [B,d]; conv_state [B,K-1,C] and h_state
    [B,G,R,P,N] (one layer's views of the cache) take the new conv tail
    and state in place.  Returns the block's output [B,d]."""
    s_cfg = cfg.ssm
    d_in, h, conv_dim = _dims(cfg)
    g, r = s_cfg.n_groups, (d_in // s_cfg.head_dim) // s_cfg.n_groups
    pdim, n = s_cfg.head_dim, s_cfg.d_state
    bsz = x.shape[0]
    hx = L.rmsnorm(p, "ln", x, cfg.norm_eps)
    z = L.dense(p, "wz", hx, "...d,di->...i")
    xbc = torch.cat([
        L.dense(p, "wx", hx, "...d,di->...i"),
        L.dense(p, "wb", hx, "...d,di->...i"),
        L.dense(p, "wc", hx, "...d,di->...i")], dim=-1)   # [B,C]
    window = torch.cat([conv_state, xbc[:, None]], dim=1)  # [B,K,C]
    y = L.einsum("bkc,kc->bc", window, p["conv/w"]) + p["conv/b"]
    y = L._act("silu", y)
    conv_state.copy_(window[:, 1:])
    xs, bs, cs = torch.split(y, [d_in, g * n, g * n], dim=-1)
    dt = L.softplus(
        L.dense(p, "wdt", hx, "...d,dh->...h").to(F32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    dA = (dt * a).reshape(bsz, g, r)
    xs = xs.reshape(bsz, g, r, pdim)
    b_r = bs.reshape(bsz, g, n)
    c_r = cs.reshape(bsz, g, n)
    xdt = xs.to(F32) * dt.reshape(bsz, g, r)[..., None]
    # h = h * exp(dA) + B x dt, in place (each op rounded as the
    # reference's two)
    h_state.mul_(torch.exp(dA)[..., None, None]).add_(
        torch.einsum("bgn,bgrp->bgrpn", b_r.to(F32), xdt))
    y_t = torch.einsum("bgn,bgrpn->bgrp", c_r.to(F32), h_state)
    y_t = y_t + xs.to(F32) * p["D"].reshape(g, r)[..., None]
    yf = y_t.reshape(bsz, d_in).to(x.dtype)
    yf = L.rmsnorm_1d(p["gnorm/scale"], yf * L._act("silu", z), cfg.norm_eps)
    out = L.dense(p, "wo", yf, "...i,id->...d")
    return x + out


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def _embed_in(params, cfg: ModelConfig, tokens):
    return L.embed(params, "embed", tokens).to(
        getattr(torch, cfg.activation_dtype))


def forward_train(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,V] float32, a 0-d float32 zero: the
    family has no aux loss); each block under ``_remat``, in one piece
    (no prefill segments)."""
    x = _embed_in(params, cfg, tokens)
    fn = _remat(lambda pp, xx: _block_seq(pp, cfg, xx)[0], cfg)
    x, _ = maybe_scan(lambda x, p_l: (fn(p_l, x), None), x,
                      subtree(params, "layers/"))
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return logits, torch.zeros((), dtype=F32, device=x.device)


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _ = forward_train(params, cfg, batch["tokens"])
    ce = L.softmax_xent(logits, batch["labels"], batch.get("mask"))
    return ce, {"ce": ce}


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B,S] -> (cache, last-position logits [B,V] float32)."""
    x = _embed_in(params, cfg, tokens)
    q = cfg.ssm.chunk_size
    seg = max(q, PREFILL_SEGMENT // q * q)

    def body(x, p_l):
        if x.shape[1] <= seg:
            x, (conv_t, h_last) = _block_seq(p_l, cfg, x)
            return x, {"conv": conv_t, "h": h_last}
        out = torch.empty_like(x)
        conv_t = h_last = None
        for lo in range(0, x.shape[1], seg):
            out[:, lo:lo + seg], (conv_t, h_last) = _block_seq(
                p_l, cfg, x[:, lo:lo + seg], h0=h_last, conv0=conv_t)
        return out, {"conv": conv_t, "h": h_last}

    x, caches = maybe_scan(body, x, subtree(params, "layers/"))
    x = L.rmsnorm(params, "ln_f", x[:, -1], cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    cache = {f"scan/{k}": v for k, v in caches.items()}
    cache["pos"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return cache, logits


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, attn_backend: Optional[str] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B] one step.  Consumes the cache: each layer's conv tail
    and SSM state are written in place.  Returns (the same tensors with
    ``pos + 1``, a new 0-d int32 tensor, and logits [B,V] float32).
    ``attn_backend`` is accepted for the uniform API; the family has no
    attention."""
    x = _embed_in(params, cfg, tokens)

    def body(x, xs):
        p_l, c_l = xs
        return _block_decode(p_l, cfg, x, c_l["conv"], c_l["h"]), None

    x, _ = maybe_scan(body, x, (subtree(params, "layers/"),
                                {"conv": cache["scan/conv"],
                                 "h": cache["scan/h"]}))
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return {**cache, "pos": cache["pos"] + 1}, logits


def cache_spec(cfg: ModelConfig, batch: int, smax: int) -> Dict[str, Tuple]:
    """name -> (shape, dtype, logical axes); none has a ``kv_seq`` axis."""
    s = cfg.ssm
    d_in, h, conv_dim = _dims(cfg)
    g, r = s.n_groups, (d_in // s.head_dim) // s.n_groups
    ll = cfg.num_layers
    return {
        "scan/conv": ((ll, batch, s.d_conv - 1, conv_dim), torch.bfloat16,
                      ("layers", "batch", "conv", "ssm_inner")),
        "scan/h": ((ll, batch, g, r, s.head_dim, s.d_state), F32,
                   ("layers", "batch", "groups", "ssm_heads", "head_dim",
                    "state")),
        "pos": ((), torch.int32, ()),
    }
