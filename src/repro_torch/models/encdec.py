"""Encoder-decoder transformer backbone (seamless-m4t-medium).

Port of ``repro/models/encdec.py``: ``loss_fn`` (each encoder and
decoder layer under the transformer's ``_remat``; the encoder's layers
under it in the prefill too, as the reference's, where without autograd
it runs them as they are), ``prefill``, ``decode_step`` and
``cache_spec``.  The audio/speech frontend is a
stub, as in the reference: the encoder consumes precomputed frame
embeddings [B, S_src, d_model].  The encoder is non-causal
self-attention with rope on the encoder positions; the decoder is causal
self-attention (KV-cached) plus cross-attention to the encoder output,
whose K/V the prefill computes once a layer.

Cache layout (stacked over decoder layers): ``"dec/k"`` / ``"dec/v"``
[L, B, Smax, Hkv, Dh] and ``"dec/xk"`` / ``"dec/xv"`` [L, B, S_src, Hkv,
Dh]; ``"pos"`` the next position as a 0-d int32 device tensor.  As in
the reference the cache is held in the activation dtype whatever
``kv_cache_dtype`` says.  A decode step writes the new token's self K/V
row in place with ``index_copy_`` at the device position, reads the
cross K/V (never written), and reads nothing back to the host: every
row of the cross attention has all S_src keys, a [B] int32 tensor filled
on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import Registrar, maybe_scan, subtree
from repro_torch.models.transformer import (_remat, _Stacked, _Step,
                                            _gqa_qkv)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_self_attn(reg, cfg: ModelConfig, path="attn") -> None:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    reg.param(f"{path}/wq/w", (d, h, dh), ("embed", "heads", "head_dim"),
              scale=d ** -0.5)
    reg.param(f"{path}/wk/w", (d, hkv, dh), ("embed", "kv_heads", "head_dim"),
              scale=d ** -0.5)
    reg.param(f"{path}/wv/w", (d, hkv, dh), ("embed", "kv_heads", "head_dim"),
              scale=d ** -0.5)
    reg.param(f"{path}/wo/w", (h, dh, d), ("heads", "head_dim", "embed"),
              scale=(h * dh) ** -0.5)


def init_cross_attn(reg, cfg: ModelConfig, path="xattn") -> None:
    _init_self_attn(reg, cfg, path=path)


def init_params(reg: Registrar, cfg: ModelConfig) -> None:
    L.init_embedding(reg, "embed", cfg.vocab_size, cfg.d_model)
    enc = _Stacked(reg, cfg.num_encoder_layers, "enc/")
    L.init_rmsnorm(enc, "ln_attn", cfg.d_model)
    _init_self_attn(enc, cfg)
    L.init_rmsnorm(enc, "ln_mlp", cfg.d_model)
    L.init_glu_mlp(enc, "mlp", cfg.d_model, cfg.d_ff)
    dec = _Stacked(reg, cfg.num_decoder_layers, "dec/")
    L.init_rmsnorm(dec, "ln_attn", cfg.d_model)
    _init_self_attn(dec, cfg)
    L.init_rmsnorm(dec, "ln_x", cfg.d_model)
    init_cross_attn(dec, cfg)
    L.init_rmsnorm(dec, "ln_mlp", cfg.d_model)
    L.init_glu_mlp(dec, "mlp", cfg.d_model, cfg.d_ff)
    L.init_rmsnorm(reg, "ln_enc_f", cfg.d_model)
    L.init_rmsnorm(reg, "ln_f", cfg.d_model)
    if not cfg.tie_embeddings:
        reg.param("head/w", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                  scale=cfg.d_model ** -0.5)


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------


def cross_kv(p, cfg: ModelConfig, ctx: torch.Tensor, path="xattn"):
    """ctx [B,Sk,d] -> (k, v) [B,Sk,hkv,dh]. No rope on cross keys."""
    k = L.dense(p, f"{path}/wk", ctx, "...d,dhk->...hk")
    v = L.dense(p, f"{path}/wv", ctx, "...d,dhk->...hk")
    return k, v


def cross_attend(p, cfg: ModelConfig, x, k, v, path="xattn",
                 lengths: Optional[torch.Tensor] = None,
                 attn_backend: Optional[str] = None):
    """x [B,Sq,d] or [B,d]; full (non-causal) attention to the context's
    K/V.  A decode query ([B,d]) runs the decode attention over every key
    (``lengths``: a [B] int32 tensor of k's length, made here if not
    given) on ``attn_backend``."""
    q = L.dense(p, f"{path}/wq", x, "...d,dhk->...hk")
    if x.dim() == 2:
        if lengths is None:
            lengths = torch.full((x.shape[0],), k.shape[1],
                                 dtype=torch.int32, device=x.device)
        o = L.decode_attention(q, k, v, lengths, backend=attn_backend)
    else:
        o = L.attention(q, k, v, causal=False, impl=cfg.attention_impl,
                        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return L.dense(p, f"{path}/wo", o, "...hk,hkd->...d")


# ---------------------------------------------------------------------------
# Encoder / decoder layers
# ---------------------------------------------------------------------------


def _enc_layer(p, cfg, x):
    h = L.rmsnorm(p, "ln_attn", x, cfg.norm_eps)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, cfg, h, positions)
    o = L.attention(q, k, v, causal=False, impl=cfg.attention_impl,
                    chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    x = x + L.dense(p, "attn/wo", o, "...hk,hkd->...d")
    h = L.rmsnorm(p, "ln_mlp", x, cfg.norm_eps)
    return x + L.glu_mlp(p, "mlp", h, cfg.mlp_act)


def encode(params, cfg: ModelConfig, src_embeds: torch.Tensor
           ) -> torch.Tensor:
    """src_embeds [B,S_src,d] -> the encoder output in the activation
    dtype."""
    x = src_embeds.to(getattr(torch, cfg.activation_dtype))
    fn = _remat(lambda pp, xx: _enc_layer(pp, cfg, xx), cfg)

    def body(x, p_l):
        return fn(p_l, x), None

    x, _ = maybe_scan(body, x, subtree(params, "enc/"))
    return L.rmsnorm(params, "ln_enc_f", x, cfg.norm_eps)


def self_attn_decode(p, cfg: ModelConfig, h, cache_l, step: _Step,
                     attn_backend: Optional[str] = None):
    """The decoder's causal self-attention for one token: h [B,d]; the
    new K/V row written at ``step.row`` of ``cache_l``'s k and v in place
    (in the cache's dtype, no ``kv_cache_dtype`` grid, as the
    reference), then attention over ``step.lengths`` keys."""
    row, posv, lengths = step
    q, k, v = _gqa_qkv(p, cfg, h, posv)
    kc, vc = cache_l["k"], cache_l["v"]
    kc.index_copy_(1, row, k[:, None].to(kc.dtype))
    vc.index_copy_(1, row, v[:, None].to(vc.dtype))
    o = L.decode_attention(q, kc, vc, lengths, backend=attn_backend)
    return L.dense(p, "attn/wo", o, "...hk,hkd->...d")


def self_attn_prefill(p, cfg: ModelConfig, h):
    """Causal self-attention over a prompt h [B,S,d]: (out, {"k", "v"})."""
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    q, k, v = _gqa_qkv(p, cfg, h, positions)
    o = L.attention(q, k, v, causal=True, impl=cfg.attention_impl,
                    chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return L.dense(p, "attn/wo", o, "...hk,hkd->...d"), {"k": k, "v": v}


def _dec_layer(p, cfg, x, *, mode: str, enc_out=None, cache_l=None,
               step: Optional[_Step] = None,
               xlens: Optional[torch.Tensor] = None,
               attn_backend: Optional[str] = None):
    """One decoder layer.  ``mode="prefill"``: x [B,S,d] against
    ``enc_out``; returns (x, the layer's k, v, xk, xv).  ``"train"``: the
    same, returning (x, None).  ``"decode"``: x [B,d] against ``cache_l``
    (views of the stacked cache; the self K/V row written in place, the
    cross K/V read); returns (x, None)."""
    h = L.rmsnorm(p, "ln_attn", x, cfg.norm_eps)
    if mode in ("train", "prefill"):
        a, new_cache = self_attn_prefill(p, cfg, h)
    else:
        a, new_cache = self_attn_decode(p, cfg, h, cache_l, step,
                                        attn_backend), None
    x = x + a
    h = L.rmsnorm(p, "ln_x", x, cfg.norm_eps)
    if mode in ("train", "prefill"):
        xk, xv = cross_kv(p, cfg, enc_out)
        new_cache.update(xk=xk, xv=xv)
        if mode == "train":
            new_cache = None
    else:
        xk, xv = cache_l["xk"], cache_l["xv"]
    x = x + cross_attend(p, cfg, h, xk, xv, lengths=xlens,
                         attn_backend=attn_backend)
    h = L.rmsnorm(p, "ln_mlp", x, cfg.norm_eps)
    return x + L.glu_mlp(p, "mlp", h, cfg.mlp_act), new_cache


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def loss_fn(params, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: src_embeds [B,S_src,d], tokens and labels [B,S] [, mask] ->
    (CE, {"ce"})."""
    tokens = batch["tokens"]
    enc_out = encode(params, cfg, batch["src_embeds"].to(tokens.device))
    x = L.embed(params, "embed", tokens).to(
        getattr(torch, cfg.activation_dtype))
    fn = _remat(lambda pp, xx: _dec_layer(pp, cfg, xx, mode="train",
                                          enc_out=enc_out)[0], cfg)
    x, _ = maybe_scan(lambda x, p_l: (fn(p_l, x), None), x,
                      subtree(params, "dec/"))
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    ce = L.softmax_xent(logits, batch["labels"], batch.get("mask"))
    return ce, {"ce": ce}


def prefill(params, cfg: ModelConfig, batch: Dict
            ) -> Tuple[Dict, torch.Tensor]:
    """batch: src_embeds [B,S_src,d], tokens [B,S] -> (cache, last-position
    logits [B,V] float32)."""
    tokens = batch["tokens"]
    enc_out = encode(params, cfg, batch["src_embeds"].to(tokens.device))
    x = L.embed(params, "embed", tokens).to(
        getattr(torch, cfg.activation_dtype))

    def body(x, p_l):
        return _dec_layer(p_l, cfg, x, mode="prefill", enc_out=enc_out)

    x, caches = maybe_scan(body, x, subtree(params, "dec/"))
    x = L.rmsnorm(params, "ln_f", x[:, -1], cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    cache = {f"dec/{k}": v for k, v in caches.items()}
    cache["pos"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return cache, logits


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor,
                attn_backend: Optional[str] = None
                ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B] one step.  Consumes the cache: the self K/V rows are
    written in place at ``pos``; the cross K/V are read only.  Returns
    (the same tensors with ``pos + 1``, a new 0-d int32 tensor, and
    logits [B,V] float32).  Reads nothing back to the host."""
    pos = cache["pos"]
    x = L.embed(params, "embed", tokens).to(
        getattr(torch, cfg.activation_dtype))
    b = x.shape[0]
    step = _Step(pos.reshape(1).long(), pos.expand(b),
                 (pos + 1).expand(b).contiguous())
    xlens = torch.full((b,), cache["dec/xk"].shape[2], dtype=torch.int32,
                       device=x.device)
    dec_cache = subtree(cache, "dec/")

    def body(x, xs):
        p_l, c_l = xs
        x, _ = _dec_layer(p_l, cfg, x, mode="decode", cache_l=c_l, step=step,
                          xlens=xlens, attn_backend=attn_backend)
        return x, None

    x, _ = maybe_scan(body, x, (subtree(params, "dec/"), dec_cache))
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return {**cache, "pos": pos + 1}, logits


def cache_spec(cfg: ModelConfig, batch: int, smax: int,
               src_len: int) -> Dict[str, Tuple]:
    """name -> (shape, dtype, logical axes); the cross entries' kv_seq
    axis is the source length."""
    dt = torch.bfloat16
    ll = cfg.num_decoder_layers
    kv = (ll, batch, smax, cfg.num_kv_heads, cfg.head_dim)
    xkv = (ll, batch, src_len, cfg.num_kv_heads, cfg.head_dim)
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "dec/k": (kv, dt, ax), "dec/v": (kv, dt, ax),
        "dec/xk": (xkv, dt, ax), "dec/xv": (xkv, dt, ax),
        "pos": ((), torch.int32, ()),
    }
