"""Llama-3.2-Vision backbone: decoder LM with gated cross-attention layers.

Port of ``repro/models/vlm.py``: ``forward_train`` and ``loss_fn``
(each superblock under the transformer's ``_remat``), ``prefill``,
``decode_step`` and ``cache_spec``.  40 layers;
every 5th layer is a gated cross-attention layer attending to
precomputed image patch embeddings (the vision frontend is a stub, as in
the reference), stacked as 8 superblocks of [4 self + 1 cross].  The
gates: x += tanh(g_attn) * xattn(...), x += tanh(g_mlp) * mlp(...), both
float32 scalars initialised to 0 (a cross layer is then the identity).

Cache layout (stacked over superblocks): ``"sb/self{j}/k"`` /
``"sb/self{j}/v"`` [n_super, B, Smax, Hkv, Dh] for the four self layers
and ``"sb/cross/xk"`` / ``"sb/cross/xv"`` [n_super, B, S_img, Hkv, Dh];
``"pos"`` a 0-d int32 device tensor.  Decode writes each self layer's
new K/V row in place, reads the cross K/V, and reads nothing back to
the host (``encdec``'s self- and cross-attention).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.encdec import (_init_self_attn, cross_attend,
                                       cross_kv, init_cross_attn,
                                       self_attn_decode, self_attn_prefill)
from repro_torch.models.param import Registrar, maybe_scan, subtree
from repro_torch.models.transformer import (_Prefixed, _Stacked, _Step,
                                            _remat)

F32 = torch.float32


def _layout(cfg: ModelConfig):
    per = cfg.cross_attn_every
    n_super = cfg.num_layers // per
    assert cfg.num_layers % per == 0, "vlm layer count must divide pattern"
    return per, n_super


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(reg: Registrar, cfg: ModelConfig) -> None:
    per, n_super = _layout(cfg)
    L.init_embedding(reg, "embed", cfg.vocab_size, cfg.d_model)
    stk = _Stacked(reg, n_super, "sb/")
    for j in range(per - 1):
        sub = _Prefixed(stk, f"self{j}/")
        L.init_rmsnorm(sub, "ln_attn", cfg.d_model)
        _init_self_attn(sub, cfg)
        L.init_rmsnorm(sub, "ln_mlp", cfg.d_model)
        L.init_glu_mlp(sub, "mlp", cfg.d_model, cfg.d_ff)
    x = _Prefixed(stk, "cross/")
    L.init_rmsnorm(x, "ln_x", cfg.d_model)
    init_cross_attn(x, cfg)
    x.param("gate_attn", (), (), init="zeros", dtype=F32)
    L.init_rmsnorm(x, "ln_mlp", cfg.d_model)
    L.init_glu_mlp(x, "mlp", cfg.d_model, cfg.d_ff)
    x.param("gate_mlp", (), (), init="zeros", dtype=F32)
    L.init_rmsnorm(reg, "ln_f", cfg.d_model)
    if not cfg.tie_embeddings:
        reg.param("head/w", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                  scale=cfg.d_model ** -0.5)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _self_layer(p, cfg, x, mode, cache_l=None, step=None, attn_backend=None):
    """Returns (x, the prefill's {"k", "v"}; None in "train" and
    "decode")."""
    h = L.rmsnorm(p, "ln_attn", x, cfg.norm_eps)
    if mode in ("train", "prefill"):
        a, new_cache = self_attn_prefill(p, cfg, h)
        if mode == "train":
            new_cache = None
    else:
        a, new_cache = self_attn_decode(p, cfg, h, cache_l, step,
                                        attn_backend), None
    x = x + a
    h = L.rmsnorm(p, "ln_mlp", x, cfg.norm_eps)
    return x + L.glu_mlp(p, "mlp", h, cfg.mlp_act), new_cache


def _cross_layer(p, cfg, x, img_embeds=None, xkv=None, xlens=None,
                 attn_backend=None):
    """The gated cross layer against the image (prefill: ``img_embeds``,
    returning its {"xk", "xv"}) or the cached image K/V (decode: ``xkv``,
    returning None)."""
    h = L.rmsnorm(p, "ln_x", x, cfg.norm_eps)
    new_cache = None
    if xkv is None:
        xk, xv = cross_kv(p, cfg, img_embeds)
        new_cache = {"xk": xk, "xv": xv}
    else:
        xk, xv = xkv
    a = cross_attend(p, cfg, h, xk, xv, lengths=xlens,
                     attn_backend=attn_backend)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * a
    h = L.rmsnorm(p, "ln_mlp", x, cfg.norm_eps)
    m = L.glu_mlp(p, "mlp", h, cfg.mlp_act)
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * m, new_cache


def _superblock(p_sb, cfg, x, img_embeds, mode, cache_sb=None, step=None,
                xlens=None, attn_backend=None):
    """Four self layers and the cross layer, in ``mode`` "train",
    "prefill" or "decode".  Prefill returns the superblock's cache
    entries; train returns None; decode writes the self rows in place
    and returns None."""
    per, _ = _layout(cfg)
    caches = {}
    for j in range(per - 1):
        c_l = subtree(cache_sb, f"self{j}/") if cache_sb else None
        x, c = _self_layer(subtree(p_sb, f"self{j}/"), cfg, x, mode,
                           cache_l=c_l, step=step, attn_backend=attn_backend)
        for ck, cv in (c or {}).items():
            caches[f"self{j}/{ck}"] = cv
    p_x = subtree(p_sb, "cross/")
    if mode == "decode":
        x, _ = _cross_layer(p_x, cfg, x, xkv=(cache_sb["cross/xk"],
                                              cache_sb["cross/xv"]),
                            xlens=xlens, attn_backend=attn_backend)
        return x, None
    x, c = _cross_layer(p_x, cfg, x, img_embeds=img_embeds)
    if mode == "train":
        return x, None
    for ck, cv in c.items():
        caches[f"cross/{ck}"] = cv
    return x, caches


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                  image_embeds: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S], image_embeds [B,S_img,d] -> (logits [B,S,V] float32,
    a 0-d float32 zero: the family has no aux loss)."""
    act = getattr(torch, cfg.activation_dtype)
    img = image_embeds.to(tokens.device, act)
    x = L.embed(params, "embed", tokens).to(act)
    fn = _remat(lambda pp, xx: _superblock(pp, cfg, xx, img, "train")[0],
                cfg)
    x, _ = maybe_scan(lambda x, p_sb: (fn(p_sb, x), None), x,
                      subtree(params, "sb/"))
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return logits, torch.zeros((), dtype=F32, device=x.device)


def loss_fn(params, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _ = forward_train(params, cfg, batch["tokens"],
                              batch["image_embeds"])
    ce = L.softmax_xent(logits, batch["labels"], batch.get("mask"))
    return ce, {"ce": ce}


def prefill(params, cfg: ModelConfig, batch: Dict
            ) -> Tuple[Dict, torch.Tensor]:
    """batch: tokens [B,S], image_embeds [B,S_img,d] -> (cache,
    last-position logits [B,V] float32)."""
    tokens = batch["tokens"]
    act = getattr(torch, cfg.activation_dtype)
    img = batch["image_embeds"].to(tokens.device, act)
    x = L.embed(params, "embed", tokens).to(act)

    def body(x, p_sb):
        return _superblock(p_sb, cfg, x, img, "prefill")

    x, caches = maybe_scan(body, x, subtree(params, "sb/"))
    x = L.rmsnorm(params, "ln_f", x[:, -1], cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    cache = {f"sb/{k}": v for k, v in caches.items()}
    cache["pos"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return cache, logits


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor,
                attn_backend: Optional[str] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B] one step.  Consumes the cache: every self layer's K/V
    row is written in place at ``pos``; the image K/V are read only.
    Returns (the same tensors with ``pos + 1``, a new 0-d int32 tensor,
    and logits [B,V] float32).  Reads nothing back to the host."""
    pos = cache["pos"]
    x = L.embed(params, "embed", tokens).to(
        getattr(torch, cfg.activation_dtype))
    b = x.shape[0]
    step = _Step(pos.reshape(1).long(), pos.expand(b),
                 (pos + 1).expand(b).contiguous())
    xlens = torch.full((b,), cache["sb/cross/xk"].shape[2],
                       dtype=torch.int32, device=x.device)

    def body(x, xs):
        p_sb, c_sb = xs
        return _superblock(p_sb, cfg, x, None, "decode", cache_sb=c_sb,
                           step=step, xlens=xlens,
                           attn_backend=attn_backend)

    x, _ = maybe_scan(body, x, (subtree(params, "sb/"),
                                subtree(cache, "sb/")))
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return {**cache, "pos": pos + 1}, logits


def cache_spec(cfg: ModelConfig, batch: int, smax: int) -> Dict[str, Tuple]:
    """name -> (shape, dtype, logical axes); the image entries' kv_seq
    axis is ``num_image_tokens``."""
    per, n_super = _layout(cfg)
    dt = torch.bfloat16
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    out: Dict[str, Tuple] = {}
    for j in range(per - 1):
        shp = (n_super, batch, smax, cfg.num_kv_heads, cfg.head_dim)
        out[f"sb/self{j}/k"] = (shp, dt, ax)
        out[f"sb/self{j}/v"] = (shp, dt, ax)
    xshp = (n_super, batch, cfg.num_image_tokens, cfg.num_kv_heads,
            cfg.head_dim)
    out["sb/cross/xk"] = (xshp, dt, ax)
    out["sb/cross/xv"] = (xshp, dt, ax)
    out["pos"] = ((), torch.int32, ())
    return out
