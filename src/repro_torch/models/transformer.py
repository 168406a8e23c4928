"""Decoder-only transformer LM, GQA branch (dense and MoE MLPs),
config-driven.

Port of ``repro/models/transformer.py`` for llama3.2-1b, qwen2.5-14b
(QKV bias), qwen3-4b (qk-norm), gemma-7b (GeGLU, embedding scale) and
qwen2-moe-a2.7b (``moe_ffn`` blocks; a config's ``first_dense_layers``
are dense blocks ``layer{i}/`` ahead of the stacked ones, each with its
own cache entries ``layer{i}/k``, ``layer{i}/v``).  MLA is a ROADMAP
item and raises.

Two serving entry points:
  - ``prefill``     — emits the KV cache + last-position logits
  - ``decode_step`` — one token against the cache

Cache layout (stacked over layers): k, v [L, B, Smax, Hkv, Dh] under
``"scan/k"`` / ``"scan/v"``; ``"pos"`` is the next position as a 0-d
int32 tensor on the cache's device, as the reference's scalar.  No step
reads it back to the host: the positions and key counts are built from
it on the device, and the new token's K/V row is written with
``index_copy_`` at a one-lane device index (a 0-d tensor index would be
read back).  ``decode_step`` writes that row into the cache in place and
returns the same tensors: the reference's ``dynamic_update_slice`` +
stacked scan output without a copy of the whole cache per step.  Every
step is the same program, so it can be captured as a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import Registrar, maybe_scan, subtree

F32 = torch.float32


class _Step(NamedTuple):
    """One decode step, on the device: the new token's row of the kv_seq
    axis as a [1] int64 index (its position; the hybrid family's ring
    slot ``pos % window``), and as int32 tensors [B] the positions and the
    key counts (``pos + 1``; the ring's ``min(pos + 1, window)``)."""
    row: torch.Tensor
    positions: torch.Tensor
    lengths: torch.Tensor


_MLA = "MLA attention is not ported yet (ROADMAP: the other LM families)"


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class _Stacked:
    """Registrar view that prepends a stacking dim (scan over layers)."""

    def __init__(self, reg: Registrar, n: int, prefix: str):
        self.reg, self.n, self.prefix = reg, n, prefix

    def param(self, path, shape, axes, **kw):
        return self.reg.param(f"{self.prefix}{path}", (self.n, *shape),
                              ("layers", *axes), **kw)


class _Prefixed:
    """Registrar view that prefixes a path (an unstacked layer)."""

    def __init__(self, reg: Registrar, prefix: str):
        self.reg, self.prefix = reg, prefix

    def param(self, path, shape, axes, **kw):
        return self.reg.param(f"{self.prefix}{path}", shape, axes, **kw)


def _check_gqa(cfg: ModelConfig) -> None:
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.name}: {_MLA}")


def _n_dense_first(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe.num_experts else 0


def _mlp_kind(cfg: ModelConfig) -> str:
    return "moe" if cfg.moe.num_experts else "dense"


def _init_attention(reg, cfg: ModelConfig, path: str = "attn") -> None:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    reg.param(f"{path}/wq/w", (d, h, dh), ("embed", "heads", "head_dim"),
              scale=d ** -0.5)
    reg.param(f"{path}/wk/w", (d, hkv, dh), ("embed", "kv_heads", "head_dim"),
              scale=d ** -0.5)
    reg.param(f"{path}/wv/w", (d, hkv, dh), ("embed", "kv_heads", "head_dim"),
              scale=d ** -0.5)
    reg.param(f"{path}/wo/w", (h, dh, d), ("heads", "head_dim", "embed"),
              scale=(h * dh) ** -0.5)
    if cfg.qkv_bias:
        reg.param(f"{path}/wq/b", (h, dh), ("heads", "head_dim"), init="zeros")
        reg.param(f"{path}/wk/b", (hkv, dh), ("kv_heads", "head_dim"),
                  init="zeros")
        reg.param(f"{path}/wv/b", (hkv, dh), ("kv_heads", "head_dim"),
                  init="zeros")
    if cfg.qk_norm:
        reg.param(f"{path}/qnorm/scale", (dh,), ("head_dim",), init="ones",
                  dtype=F32)
        reg.param(f"{path}/knorm/scale", (dh,), ("head_dim",), init="ones",
                  dtype=F32)


def _init_block(reg, cfg: ModelConfig, mlp_kind: str,
                dense_ff: int = 0) -> None:
    L.init_rmsnorm(reg, "ln_attn", cfg.d_model)
    _init_attention(reg, cfg)
    L.init_rmsnorm(reg, "ln_mlp", cfg.d_model)
    if mlp_kind == "dense":
        L.init_glu_mlp(reg, "mlp", cfg.d_model, dense_ff or cfg.d_ff)
    else:
        L.init_moe(reg, "moe", cfg.d_model, cfg.moe)


def init_params(reg: Registrar, cfg: ModelConfig) -> None:
    _check_gqa(cfg)
    L.init_embedding(reg, "embed", cfg.vocab_size, cfg.d_model)
    n_first = _n_dense_first(cfg)
    for i in range(n_first):
        _init_block(_Prefixed(reg, f"layer{i}/"), cfg, "dense",
                    dense_ff=cfg.moe.first_dense_d_ff)
    _init_block(_Stacked(reg, cfg.num_layers - n_first, "layers/"), cfg,
                _mlp_kind(cfg))
    L.init_rmsnorm(reg, "ln_f", cfg.d_model)
    if not cfg.tie_embeddings:
        reg.param("head/w", (cfg.d_model, cfg.vocab_size),
                  ("embed", "vocab"), scale=cfg.d_model ** -0.5)


# ---------------------------------------------------------------------------
# Attention apply
# ---------------------------------------------------------------------------


def _gqa_qkv(p, cfg: ModelConfig, x, positions):
    q = L.dense(p, "attn/wq", x, "...d,dhk->...hk")
    k = L.dense(p, "attn/wk", x, "...d,dhk->...hk")
    v = L.dense(p, "attn/wv", x, "...d,dhk->...hk")
    if cfg.qk_norm:
        q = L.rmsnorm_1d(p["attn/qnorm/scale"], q, cfg.norm_eps)
        k = L.rmsnorm_1d(p["attn/knorm/scale"], k, cfg.norm_eps)
    # rope over the seq axis (axis -3 carries S for [B,S,H,D], absent for
    # decode)
    if x.dim() == 3:
        q = L.rope(q.transpose(-2, -3), positions,
                   cfg.rope_theta).transpose(-2, -3)
        k = L.rope(k.transpose(-2, -3), positions,
                   cfg.rope_theta).transpose(-2, -3)
    else:
        q = L.rope(q, positions[..., None], cfg.rope_theta)
        k = L.rope(k, positions[..., None], cfg.rope_theta)
    return q, k, v


def _attn_prefill(p, cfg: ModelConfig, x):
    """Returns (out, cache_entry_dict)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    o = L.attention(q, k, v, causal=True, impl=cfg.attention_impl,
                    chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    out = L.dense(p, "attn/wo", o, "...hk,hkd->...d")
    return out, {"k": _kv_store(cfg, k), "v": _kv_store(cfg, v)}


def _attn_decode(p, cfg: ModelConfig, x, cache_l, step: _Step,
                 attn_backend: Optional[str] = None):
    """x [B,d]; cache_l per-layer dict of views into the stacked cache;
    ``step`` the step's position index and int32 tensors.  Writes the
    new K/V row at ``step.row`` in place and returns (out, the same cache
    views)."""
    row, posv, lengths = step
    q, k, v = _gqa_qkv(p, cfg, x, posv)
    kc, vc = cache_l["k"], cache_l["v"]
    kc.index_copy_(1, row, _kv_store(cfg, k)[:, None].to(kc.dtype))
    vc.index_copy_(1, row, _kv_store(cfg, v)[:, None].to(vc.dtype))
    o = L.decode_attention(q, _kv_load(cfg, kc), _kv_load(cfg, vc),
                           lengths, backend=attn_backend)
    out = L.dense(p, "attn/wo", o, "...hk,hkd->...d")
    return out, {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# Block (attention + MLP)
# ---------------------------------------------------------------------------


def _block_apply(p, cfg: ModelConfig, x, mlp_kind: str, *, mode: str,
                 cache_l=None, step: Optional[_Step] = None,
                 attn_backend: Optional[str] = None):
    """Attention + GLU MLP (dense) or ``moe_ffn`` (decode: on ``h[:,
    None]``), pre-norm residual; returns (x_out, new_cache_entry).  The
    MoE aux loss is a training term, and serving drops it."""
    h = L.rmsnorm(p, "ln_attn", x, cfg.norm_eps)
    if mode == "prefill":
        a, new_cache = _attn_prefill(p, cfg, h)
    else:
        a, new_cache = _attn_decode(p, cfg, h, cache_l, step,
                                    attn_backend=attn_backend)
    x = x + a
    h = L.rmsnorm(p, "ln_mlp", x, cfg.norm_eps)
    if mlp_kind == "dense":
        m = L.glu_mlp(p, "mlp", h, cfg.mlp_act)
    elif mode == "decode":
        m = L.moe_ffn(p, "moe", h[:, None], cfg.moe, cfg.mlp_act)[0][:, 0]
    else:
        m = L.moe_ffn(p, "moe", h, cfg.moe, cfg.mlp_act)[0]
    return x + m, new_cache


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed_in(params, cfg: ModelConfig, tokens):
    x = L.embed(params, "embed", tokens).to(getattr(torch,
                                                    cfg.activation_dtype))
    if cfg.mlp_act == "gelu":          # gemma-family embedding scaling
        # the reference multiplies by the scale rounded to the activation
        # dtype; a Python number keeps it off the device (no host copy)
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B,S] -> (cache, last-position logits [B,V] float32)."""
    _check_gqa(cfg)
    x = _embed_in(params, cfg, tokens)
    head_caches = []
    for i in range(_n_dense_first(cfg)):
        x, c = _block_apply(subtree(params, f"layer{i}/"), cfg, x, "dense",
                            mode="prefill")
        head_caches.append(c)
    mlp_kind = _mlp_kind(cfg)

    def body(x, p_l):
        return _block_apply(p_l, cfg, x, mlp_kind, mode="prefill")

    x, caches = maybe_scan(body, x, subtree(params, "layers/"))
    x = L.rmsnorm(params, "ln_f", x[:, -1], cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    cache: Dict[str, Any] = {f"scan/{k}": v for k, v in caches.items()}
    for i, c in enumerate(head_caches):
        for k, v in c.items():
            cache[f"layer{i}/{k}"] = v
    cache["pos"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return cache, logits


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, attn_backend: Optional[str] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B] one step; cache from prefill (+ ``grow_cache``).
    Consumes the cache: its K/V tensors are updated in place (a caller
    that keeps the old dict sees the new rows).  Returns (the same
    tensors with ``pos + 1``, a new 0-d int32 tensor, and logits [B,V]
    float32).  Reads nothing back to the host."""
    _check_gqa(cfg)
    pos = cache["pos"]
    x = _embed_in(params, cfg, tokens)
    # the step's position index, positions and key counts, built once on
    # the device for every layer
    b = x.shape[0]
    step = _Step(pos.reshape(1).long(), pos.expand(b),
                 (pos + 1).expand(b).contiguous())
    for i in range(_n_dense_first(cfg)):
        cl = {k.split("/", 1)[1]: v for k, v in cache.items()
              if k.startswith(f"layer{i}/")}
        x, _ = _block_apply(subtree(params, f"layer{i}/"), cfg, x, "dense",
                            mode="decode", cache_l=cl, step=step,
                            attn_backend=attn_backend)
    mlp_kind = _mlp_kind(cfg)
    scan_cache = {k[len("scan/"):]: v for k, v in cache.items()
                  if k.startswith("scan/")}

    def body(x, xs):
        p_l, cl = xs
        x, _ = _block_apply(p_l, cfg, x, mlp_kind, mode="decode",
                            cache_l=cl, step=step,
                            attn_backend=attn_backend)
        return x, None

    x, _ = maybe_scan(body, x, (subtree(params, "layers/"), scan_cache))
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return {**cache, "pos": pos + 1}, logits


# ---------------------------------------------------------------------------
# KV cache storage and specs
# ---------------------------------------------------------------------------


_KV_SCALE = 64.0  # static int8 KV grid (per-tensor)


def _kv_store(cfg: ModelConfig, x):
    if cfg.kv_cache_dtype == "int8":
        return torch.clamp(torch.round(x.to(F32) * _KV_SCALE),
                           -127, 127).to(torch.int8)
    return x


def _kv_load(cfg: ModelConfig, x):
    if cfg.kv_cache_dtype == "int8":
        return x.to(torch.bfloat16) * (1.0 / _KV_SCALE)
    return x


def cache_spec(cfg: ModelConfig, batch: int, smax: int) -> Dict[str, Tuple]:
    """name -> (shape, dtype, logical axes)."""
    _check_gqa(cfg)
    dt = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    n_first = _n_dense_first(cfg)
    out: Dict[str, Tuple] = {}

    def entry(prefix, lead=()):
        la = ("layers",) if lead else ()
        shp = (*lead, batch, smax, cfg.num_kv_heads, cfg.head_dim)
        ax = (*la, "batch", "kv_seq", "kv_heads", "head_dim")
        out[f"{prefix}k"] = (shp, dt, ax)
        out[f"{prefix}v"] = (shp, dt, ax)

    for i in range(n_first):
        entry(f"layer{i}/")
    entry("scan/", lead=(cfg.num_layers - n_first,))
    out["pos"] = ((), torch.int32, ())
    return out
