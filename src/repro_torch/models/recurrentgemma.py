"""RecurrentGemma / Griffin: RG-LRU recurrent blocks + local attention, 2:1.

Port of ``repro/models/recurrentgemma.py``: ``loss_fn``
(``forward_train``: every superblock layer under the transformer's
``_remat``, the tail's layers as they are, as the reference's),
``prefill``, ``decode_step`` and ``cache_spec``.  Layer pattern
(recurrent, recurrent, attention) repeating; each layer is a temporal
block + GeGLU MLP with pre-norms and residuals.  The
whole superblocks are stacked under ``"sb/l{j}/"``, the pattern's
remainder (``num_layers % 3`` layers) under ``"tail/l{j}/"``: the full
38 layers are 12 x (r, r, a) + (r, r).

Recurrent block: x -> [gelu(W_gate x)] * RG_LRU(conv1d(W_in x)) -> W_out.
RG-LRU: r_t = sigma(block_diag(W_a) x_t); i_t = sigma(block_diag(W_i) x_t)
        log a_t = -c * softplus(Lambda) * r_t   (c = 8)
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Prefill runs the recurrence through ``param.associative_scan`` (JAX's
log-depth algorithm, each level a few whole-tensor ops).  A prompt of
more than ``PREFILL_TOKENS`` tokens runs each layer in segments
(long_500k's 524288 tokens would not fit one card in one piece).

Attention block: MQA (kv=1) with rope and a 2048-token sliding window;
the decode cache is a ring of window slots (slot = pos % window).  A
decode step computes the slot and the key counts min(pos + 1, window)
on the device from the 0-d ``pos``, writes the new K/V row with a
one-lane ``index_copy_`` and calls ``layers.decode_attention`` on the
ring without a window.  Every recurrent layer's conv tail and state are
written into the cache in place, so the step reads nothing back to the
host and a CUDA graph can replay it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import _causal_conv
from repro_torch.models.param import (Registrar, associative_scan,
                                      maybe_scan, subtree)
from repro_torch.models.transformer import (_Prefixed, _Stacked, _Step,
                                            _gqa_qkv, _remat)

F32 = torch.float32
# a prefill of more than this many tokens (batch x length) runs each layer
# over segments of ``PREFILL_TOKENS // batch`` positions, carrying the
# recurrent blocks' conv tail and state and the attention blocks' last
# ``window - 1`` K/V rows from one segment to the next.  A layer's
# transients at full width are ~200 KB a token: the band attention's
# float32 scores of one band, 16 heads x 1024 keys x 4 bytes = 64 KB,
# and its bfloat16 p, 32 KB; the GeGLU's gate and up, 24 KB each; the
# RG-LRU's float32 gates, 16 KB each, and the scan's levels about as much
# again.  65536 tokens hold ~13 GB; long_500k's 524288 in one piece
# would hold ~105 GB beside the 17.2 GB of weights.  The associative
# scan's tree and the attention's blocks differ by segment, so the
# values differ from one whole-prompt pass by rounding only.
PREFILL_TOKENS = 1 << 16
_LRU_C = 8.0
_N_BLOCKS = 16  # block-diagonal gate projections (Griffin appendix)


def _w(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_recurrent(reg, cfg: ModelConfig) -> None:
    d, w = cfg.d_model, _w(cfg)
    L.init_rmsnorm(reg, "ln", d)
    reg.param("wgate/w", (d, w), ("embed", "lru"), scale=d ** -0.5)
    reg.param("win/w", (d, w), ("embed", "lru"), scale=d ** -0.5)
    reg.param("conv/w", (cfg.hybrid.conv_width, w), ("conv", "lru"),
              scale=cfg.hybrid.conv_width ** -0.5)
    reg.param("conv/b", (w,), ("lru",), init="zeros")
    nb = _N_BLOCKS
    reg.param("wa/w", (nb, w // nb, w // nb), ("blocks", "lru", "lru"),
              scale=(w // nb) ** -0.5)
    reg.param("wa/b", (w,), ("lru",), init="zeros")
    reg.param("wi/w", (nb, w // nb, w // nb), ("blocks", "lru", "lru"),
              scale=(w // nb) ** -0.5)
    reg.param("wi/b", (w,), ("lru",), init="zeros")
    reg.param("lam", (w,), ("lru",), init="uniform", scale=1.0, dtype=F32)
    reg.param("wout/w", (w, d), ("lru", "embed"), scale=w ** -0.5)


def _init_attention(reg, cfg: ModelConfig) -> None:
    d, h, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    L.init_rmsnorm(reg, "ln", d)
    reg.param("attn/wq/w", (d, h, dh), ("embed", "heads", "head_dim"),
              scale=d ** -0.5)
    reg.param("attn/wk/w", (d, cfg.num_kv_heads, dh),
              ("embed", "kv_heads", "head_dim"), scale=d ** -0.5)
    reg.param("attn/wv/w", (d, cfg.num_kv_heads, dh),
              ("embed", "kv_heads", "head_dim"), scale=d ** -0.5)
    reg.param("attn/wo/w", (h, dh, d), ("heads", "head_dim", "embed"),
              scale=(h * dh) ** -0.5)


def _init_mlp(reg, cfg: ModelConfig) -> None:
    L.init_rmsnorm(reg, "ln_mlp", cfg.d_model)
    L.init_glu_mlp(reg, "mlp", cfg.d_model, cfg.d_ff)


def _pattern_split(cfg: ModelConfig):
    pat = cfg.hybrid.pattern
    n_super = cfg.num_layers // len(pat)
    tail = cfg.num_layers % len(pat)
    return pat, n_super, pat[:tail]


def init_params(reg: Registrar, cfg: ModelConfig) -> None:
    L.init_embedding(reg, "embed", cfg.vocab_size, cfg.d_model)
    pat, n_super, tail = _pattern_split(cfg)
    stk = _Stacked(reg, n_super, "sb/")
    for j, kind in enumerate(pat):
        sub = _Prefixed(stk, f"l{j}/")
        (_init_recurrent if kind == "recurrent" else _init_attention)(sub, cfg)
        _init_mlp(sub, cfg)
    for j, kind in enumerate(tail):
        sub = _Prefixed(reg, f"tail/l{j}/")
        (_init_recurrent if kind == "recurrent" else _init_attention)(sub, cfg)
        _init_mlp(sub, cfg)
    L.init_rmsnorm(reg, "ln_f", cfg.d_model)
    if not cfg.tie_embeddings:
        reg.param("head/w", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                  scale=cfg.d_model ** -0.5)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _block_diag(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """x [..., W] through block-diagonal linear [nb, W/nb, W/nb]."""
    nb = p[f"{name}/w"].shape[0]
    shp = x.shape
    xr = x.reshape(*shp[:-1], nb, shp[-1] // nb)
    y = L.einsum("...ni,nio->...no", xr, L.W(p, f"{name}/w"))
    return y.reshape(shp) + p[f"{name}/b"]


def _lru_combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _lru_gates(p, x: torch.Tensor):
    """(a, sqrt(1 - a^2) * i * x) in float32 for x [..., W]."""
    r = L.sigmoid(_block_diag(p, "wa", x).to(F32))
    i = L.sigmoid(_block_diag(p, "wi", x).to(F32))
    log_a = -_LRU_C * L.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * x.to(F32))
    return a, gated


def _rg_lru_seq(p, x: torch.Tensor, h0=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,W] -> (y [B,S,W], h_last [B,W]); linear recurrence via the
    associative scan."""
    a, gated = _lru_gates(p, x)
    if h0 is not None:
        # fold the carry-in into the first step: b_0 += a_0 * h0
        gated[:, 0] += a[:, 0] * h0
    _, h = associative_scan(_lru_combine, (a, gated), axis=1)
    return h.to(x.dtype), h[:, -1]


def _recurrent_block_seq(p, cfg, x, state=None):
    """x [B,S,d]. state = (conv_tail, h0) or None. Returns (y, new_state)."""
    hx = L.rmsnorm(p, "ln", x, cfg.norm_eps)
    gate = L._act("gelu", L.dense(p, "wgate", hx, "...d,dw->...w"))
    u = L.dense(p, "win", hx, "...d,dw->...w")
    kw = cfg.hybrid.conv_width
    s = u.shape[1]
    if state is not None:
        conv0, h0 = state
        u_in = torch.cat([conv0, u], dim=1)
        conv_tail = u_in[:, -(kw - 1):]
        uc = _causal_conv(u_in, p["conv/w"], p["conv/b"])[:, -s:]
    else:
        h0 = None
        conv_tail = u[:, max(0, s - (kw - 1)):]
        if conv_tail.shape[1] < kw - 1:
            conv_tail = F.pad(conv_tail,
                              (0, 0, kw - 1 - conv_tail.shape[1], 0))
        uc = _causal_conv(u, p["conv/w"], p["conv/b"])
    y, h_last = _rg_lru_seq(p, uc, h0=h0)
    out = L.dense(p, "wout", gate * y, "...w,wd->...d")
    # copies: views would keep the whole u and scan output alive
    return x + out, (conv_tail.clone(), h_last.clone())


def _recurrent_block_step(p, cfg, x, conv_state, h_state):
    """Single token. x [B,d]; conv_state [B,K-1,W] and h_state [B,W] (one
    layer's views of the cache) take the new conv tail and state in
    place.  Returns the block's output [B,d]."""
    hx = L.rmsnorm(p, "ln", x, cfg.norm_eps)
    gate = L._act("gelu", L.dense(p, "wgate", hx, "...d,dw->...w"))
    u = L.dense(p, "win", hx, "...d,dw->...w")
    win = torch.cat([conv_state, u[:, None]], dim=1)           # [B,K,W]
    uc = L.einsum("bkw,kw->bw", win, p["conv/w"]) + p["conv/b"]
    a, gated = _lru_gates(p, uc)
    h = a * h_state + gated
    out = L.dense(p, "wout", gate * h.to(x.dtype), "...w,wd->...d")
    conv_state.copy_(win[:, 1:])
    h_state.copy_(h)
    return x + out


# ---------------------------------------------------------------------------
# Attention layer (MQA + window; ring-buffer decode cache)
# ---------------------------------------------------------------------------


def _attn_block_seq(p, cfg, x, start=0, prefix=None):
    """x [B,S,d], the prompt's positions ``start`` .. ``start + S - 1``;
    ``prefix`` the (k, v) rows of the positions before, at most
    ``window - 1`` (a later segment's).  Returns (x + out, (k, v) of the
    prefix and this segment: the keys in the window of the next)."""
    hx = L.rmsnorm(p, "ln", x, cfg.norm_eps)
    win = cfg.hybrid.attention_window
    positions = torch.arange(start, start + x.shape[1],
                             device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, cfg, hx, positions)
    n_pre = 0
    if prefix is not None:
        # the prefix rows go through the square causal layout with zero
        # queries, whose outputs are dropped: the band attention's work
        # (S x window), where the Sq < Skv layout's kv-block loop would
        # take S x (S + window - 1)
        n_pre = prefix[0].shape[1]
        q = torch.cat([q.new_zeros((q.shape[0], n_pre, *q.shape[2:])), q],
                      dim=1)
        k = torch.cat([prefix[0], k], dim=1)
        v = torch.cat([prefix[1], v], dim=1)
    o = L.attention(q, k, v, causal=True, impl=cfg.attention_impl,
                    chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                    window=win)[:, n_pre:]
    out = L.dense(p, "attn/wo", o, "...hk,hkd->...d")
    return x + out, (k, v)


def _ring(kv, s: int, win: int):
    """The decode cache of an attention layer after ``s`` prompt
    positions, from (k, v) whose last row is position ``s - 1`` (and
    that hold every position when ``s < win``): the last ``win`` rows in
    ring order, slot = pos % win."""
    out = {}
    for name, t in zip(("k", "v"), kv):
        if s >= win:
            # rotate so that slot index = position % win
            out[name] = torch.roll(t[:, -win:], s % win, dims=1)
        else:
            out[name] = F.pad(t, (0, 0, 0, 0, 0, win - s))
    return out


def _attn_block_step(p, cfg, x, cache_l, step: _Step,
                     attn_backend: Optional[str] = None):
    """x [B,d]; cache_l the layer's ring views {"k", "v"} [B,win,Hkv,D];
    ``step.row`` is the ring slot ``pos % win``, where the new row goes in
    place, and ``step.lengths`` the key counts min(pos + 1, win)."""
    hx = L.rmsnorm(p, "ln", x, cfg.norm_eps)
    posv = step.positions
    q = L.dense(p, "attn/wq", hx, "...d,dhk->...hk")
    k = L.dense(p, "attn/wk", hx, "...d,dhk->...hk")
    v = L.dense(p, "attn/wv", hx, "...d,dhk->...hk")
    q = L.rope(q, posv[:, None], cfg.rope_theta)
    k = L.rope(k, posv[:, None], cfg.rope_theta)
    kc, vc = cache_l["k"], cache_l["v"]
    kc.index_copy_(1, step.row, k[:, None].to(kc.dtype))
    vc.index_copy_(1, step.row, v[:, None].to(vc.dtype))
    o = L.decode_attention(q, kc, vc, step.lengths, backend=attn_backend)
    out = L.dense(p, "attn/wo", o, "...hk,hkd->...d")
    return x + out


def _mlp_block(p, cfg, x):
    h = L.rmsnorm(p, "ln_mlp", x, cfg.norm_eps)
    return x + L.glu_mlp(p, "mlp", h, cfg.mlp_act)


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def _layer_train(p_l, cfg, x, kind):
    """One layer (temporal block + MLP) over the whole sequence, in one
    piece and emitting no cache (the reference's ``_layer_seq`` with
    ``emit_cache=False``)."""
    if kind == "recurrent":
        x = _recurrent_block_seq(p_l, cfg, x)[0]
    else:
        x = _attn_block_seq(p_l, cfg, x)[0]
    return _mlp_block(p_l, cfg, x)


def _layer_seq(p_l, cfg, x, kind):
    """One layer (temporal block + MLP) over the prompt: in one piece, or
    past ``PREFILL_TOKENS`` in segments, each carrying the recurrent
    state or the attention's last ``window - 1`` K/V rows into the next.
    Returns (x, the layer's decode cache)."""
    b, s = x.shape[:2]
    win = cfg.hybrid.attention_window
    seg = max(1, PREFILL_TOKENS // b)
    out = x if s <= seg else torch.empty_like(x)
    state = None
    for lo in range(0, s, seg):
        xs = x[:, lo:lo + seg]
        if kind == "recurrent":
            y, state = _recurrent_block_seq(p_l, cfg, xs, state=state)
        else:
            y, kv = _attn_block_seq(p_l, cfg, xs, start=lo, prefix=state)
            # copies: views would keep the segment's K/V alive
            state = tuple(t[:, max(0, t.shape[1] - win + 1):].clone()
                          for t in kv)
        y = _mlp_block(p_l, cfg, y)
        if s <= seg:
            out = y
        else:
            out[:, lo:lo + seg] = y
    if kind == "recurrent":
        return out, {"conv": state[0], "h": state[1]}
    return out, _ring(kv, s, win)


def _embed_in(params, cfg: ModelConfig, tokens):
    x = L.embed(params, "embed", tokens).to(getattr(torch,
                                                    cfg.activation_dtype))
    # gemma embedding scaling by the scale rounded to the activation
    # dtype (a Python number: no host copy)
    return x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))


def _run_seq(params, cfg: ModelConfig, tokens):
    """Every layer over the prompt: (x, the superblocks' stacked caches,
    the tail layers' caches)."""
    x = _embed_in(params, cfg, tokens)
    pat, n_super, tail = _pattern_split(cfg)

    def body(x, p_sb):
        caches = {}
        for j, kind in enumerate(pat):
            x, c = _layer_seq(subtree(p_sb, f"l{j}/"), cfg, x, kind)
            caches.update({f"l{j}/{ck}": cv for ck, cv in c.items()})
        return x, caches

    x, sb_caches = maybe_scan(body, x, subtree(params, "sb/"))
    tail_caches = {}
    for j, kind in enumerate(tail):
        x, c = _layer_seq(subtree(params, f"tail/l{j}/"), cfg, x, kind)
        tail_caches.update({f"tail/l{j}/{ck}": cv for ck, cv in c.items()})
    return x, sb_caches or {}, tail_caches


def forward_train(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,V] float32, a 0-d float32 zero: the
    family has no aux loss)."""
    x = _embed_in(params, cfg, tokens)
    pat, n_super, tail = _pattern_split(cfg)
    fns = [_remat(lambda pp, xx, kk=kind: _layer_train(pp, cfg, xx, kk), cfg)
           for kind in pat]

    def body(x, p_sb):
        for j, fn in enumerate(fns):
            x = fn(subtree(p_sb, f"l{j}/"), x)
        return x, None

    if n_super:
        x, _ = maybe_scan(body, x, subtree(params, "sb/"))
    for j, kind in enumerate(tail):
        x = _layer_train(subtree(params, f"tail/l{j}/"), cfg, x, kind)
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
    x, sb_caches, tail_caches = _run_seq(params, cfg, tokens)
    x = L.rmsnorm(params, "ln_f", x[:, -1], cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    cache = {f"sb/{k}": v for k, v in sb_caches.items()}
    cache.update(tail_caches)
    cache["pos"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return cache, logits


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, attn_backend: Optional[str] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B] one step.  Consumes the cache: the recurrent layers'
    conv tails and states and the attention layers' ring slot are
    written in place.  Returns (the same tensors with ``pos + 1``, a new
    0-d int32 tensor, and logits [B,V] float32).  Reads nothing back to
    the host."""
    pos = cache["pos"]
    x = _embed_in(params, cfg, tokens)
    pat, n_super, tail = _pattern_split(cfg)
    win = cfg.hybrid.attention_window
    b = x.shape[0]
    # the ring slot pos % win and the key counts min(pos + 1, win), on
    # the device, once for every attention layer
    step = _Step(torch.remainder(pos, win).reshape(1).long(), pos.expand(b),
                 torch.clamp_max(pos + 1, win).expand(b).contiguous())

    def layer(p_l, c_l, kind, x):
        if kind == "recurrent":
            x = _recurrent_block_step(p_l, cfg, x, c_l["conv"], c_l["h"])
        else:
            x = _attn_block_step(p_l, cfg, x, c_l, step,
                                 attn_backend=attn_backend)
        return _mlp_block(p_l, cfg, x)

    def body(x, xs):
        p_sb, c_sb = xs
        for j, kind in enumerate(pat):
            x = layer(subtree(p_sb, f"l{j}/"), subtree(c_sb, f"l{j}/"),
                      kind, x)
        return x, None

    if n_super:
        x, _ = maybe_scan(body, x, (subtree(params, "sb/"),
                                    subtree(cache, "sb/")))
    for j, kind in enumerate(tail):
        x = layer(subtree(params, f"tail/l{j}/"),
                  subtree(cache, f"tail/l{j}/"), kind, x)
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return {**cache, "pos": pos + 1}, logits


def cache_spec(cfg: ModelConfig, batch: int, smax: int) -> Dict[str, Tuple]:
    """name -> (shape, dtype, logical axes).  The ring's K/V entries have
    a ``kv_seq`` axis of ``attention_window`` slots (whatever ``smax``);
    the recurrent entries (conv tail, state) and ``pos`` have none."""
    pat, n_super, tail = _pattern_split(cfg)
    w = _w(cfg)
    kw = cfg.hybrid.conv_width
    win = cfg.hybrid.attention_window
    dt = torch.bfloat16
    out: Dict[str, Tuple] = {}

    def rec_entries(prefix, lead=()):
        la = ("layers",) if lead else ()
        out[f"{prefix}conv"] = ((*lead, batch, kw - 1, w), dt,
                                (*la, "batch", "conv", "lru"))
        out[f"{prefix}h"] = ((*lead, batch, w), F32, (*la, "batch", "lru"))

    def attn_entries(prefix, lead=()):
        la = ("layers",) if lead else ()
        shp = (*lead, batch, win, cfg.num_kv_heads, cfg.head_dim)
        ax = (*la, "batch", "kv_seq", "kv_heads", "head_dim")
        out[f"{prefix}k"] = (shp, dt, ax)
        out[f"{prefix}v"] = (shp, dt, ax)

    for j, kind in enumerate(pat):
        (rec_entries if kind == "recurrent" else attn_entries)(
            f"sb/l{j}/", lead=(n_super,))
    for j, kind in enumerate(tail):
        (rec_entries if kind == "recurrent" else attn_entries)(f"tail/l{j}/")
    out["pos"] = ((), torch.int32, ())
    return out
