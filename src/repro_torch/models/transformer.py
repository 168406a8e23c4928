"""Decoder-only transformer LM: dense and MoE MLPs, GQA and MLA
attention, config-driven.

Port of ``repro/models/transformer.py`` for llama3.2-1b, qwen2.5-14b
(QKV bias), qwen3-4b (qk-norm), gemma-7b (GeGLU, embedding scale),
qwen2-moe-a2.7b (``moe_ffn`` blocks; a config's ``first_dense_layers``
are dense blocks ``layer{i}/`` ahead of the stacked ones, each with its
own cache entries) and deepseek-v2-236b (MLA: multi-head latent
attention, over MoE blocks).

Three entry points, as the reference's:
  - ``loss_fn``     (train_4k) — CE + MoE aux over ``forward_train``:
                    every layer under ``_remat`` (activation
                    checkpointing) and autograd for the gradients
  - ``prefill``     — emits the KV cache + last-position logits
  - ``decode_step`` — one token against the cache

Cache layouts (stacked over layers): GQA k, v [L, B, Smax, Hkv, Dh]
under ``"scan/k"`` / ``"scan/v"``; MLA the compressed latent ckv [L, B,
Smax, R] and the shared rope key kpe [L, B, Smax, Dr] under
``"scan/ckv"`` / ``"scan/kpe"``.  ``"pos"`` is the next position as a
0-d int32 tensor on the cache's device, as the reference's scalar.  No
step reads it back to the host: the positions and key counts are built
from it on the device, and the new token's row is written with
``index_copy_`` at a one-lane device index (a 0-d tensor index would be
read back).  ``decode_step`` writes that row into the cache in place and
returns the same tensors: the reference's ``dynamic_update_slice`` +
stacked scan output without a copy of the whole cache per step.  Every
step is the same program, so it can be captured as a CUDA graph.

MLA prefill attends over per-head K/V decompressed from the latent
(``_mla_qkv_full``) and caches the latent; MLA decode is the reference's
matrix-absorbed form (``_mla_decode``): W_UK folded into the query,
float32 scores over the latent cache, W_UV applied after the softmax.
It is plain torch ops, as the reference's is plain ``jnp.einsum``: no
kernel of the port runs on it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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


def _n_dense_first(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe.num_experts else 0


def _mlp_kind(cfg: ModelConfig) -> str:
    return "moe" if cfg.moe.num_experts else "dense"


def _init_attention(reg, cfg: ModelConfig, path: str = "attn") -> None:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == "mla":
        r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                         cfg.qk_nope_head_dim, cfg.v_head_dim)
        if cfg.q_lora_rank:
            reg.param(f"{path}/wdq/w", (d, cfg.q_lora_rank),
                      ("embed", "q_lora"), scale=d ** -0.5)
            reg.param(f"{path}/q_norm/scale", (cfg.q_lora_rank,), ("q_lora",),
                      init="ones", dtype=F32)
            reg.param(f"{path}/wuq/w", (cfg.q_lora_rank, h, dn + dr),
                      ("q_lora", "heads", "qk_dim"),
                      scale=cfg.q_lora_rank ** -0.5)
        else:
            reg.param(f"{path}/wq/w", (d, h, dn + dr),
                      ("embed", "heads", "qk_dim"), scale=d ** -0.5)
        reg.param(f"{path}/wdkv/w", (d, r), ("embed", "kv_lora"),
                  scale=d ** -0.5)
        reg.param(f"{path}/kv_norm/scale", (r,), ("kv_lora",), init="ones",
                  dtype=F32)
        reg.param(f"{path}/wkr/w", (d, dr), ("embed", "qk_dim"),
                  scale=d ** -0.5)
        reg.param(f"{path}/wuk/w", (r, h, dn), ("kv_lora", "heads", "qk_dim"),
                  scale=r ** -0.5)
        reg.param(f"{path}/wuv/w", (r, h, dv), ("kv_lora", "heads", "v_dim"),
                  scale=r ** -0.5)
        reg.param(f"{path}/wo/w", (h, dv, d), ("heads", "v_dim", "embed"),
                  scale=(h * dv) ** -0.5)
        return
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


def _mla_q(p, cfg: ModelConfig, x):
    """The per-head query [..., H, Dn + Dr] through the q-LoRA (wdq, its
    norm, wuq) or the full-rank wq.  The reference's ``_rms`` (the q and
    latent norms) is ``rmsnorm_1d`` op for op."""
    if cfg.q_lora_rank:
        cq = L.rmsnorm_1d(p["attn/q_norm/scale"],
                          L.dense(p, "attn/wdq", x, "...d,dr->...r"),
                          cfg.norm_eps)
        return L.einsum("...r,rhk->...hk", cq, L.W(p, "attn/wuq/w"))
    return L.dense(p, "attn/wq", x, "...d,dhk->...hk")


def _mla_latent(p, cfg: ModelConfig, x):
    """The normed latent ckv [..., R] and the shared rope key before its
    rope [..., Dr]."""
    ckv = L.rmsnorm_1d(p["attn/kv_norm/scale"],
                       L.dense(p, "attn/wdkv", x, "...d,dr->...r"),
                       cfg.norm_eps)
    return ckv, L.dense(p, "attn/wkr", x, "...d,dk->...k")


def _mla_qkv_full(p, cfg: ModelConfig, x, positions):
    """Decompressed MLA for train and prefill: per-head K/V materialized
    from the latent.  Returns (q, k, v, the latent ckv [B,S,R], the
    shared rope key k_pe [B,S,Dr]); q and k are Dn + Dr wide, v Dv."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    qh = _mla_q(p, cfg, x)
    q_nope, q_pe = qh[..., :dn], qh[..., dn:]
    ckv, k_pe = _mla_latent(p, cfg, x)
    q_pe = L.rope(q_pe.transpose(-2, -3), positions,
                  cfg.rope_theta).transpose(-2, -3)
    k_pe = L.rope(k_pe, positions, cfg.rope_theta)
    k_nope = L.einsum("...r,rhk->...hk", ckv, L.W(p, "attn/wuk/w"))
    v = L.einsum("...r,rhe->...he", ckv, L.W(p, "attn/wuv/w"))
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[..., None, :].expand(*k_nope.shape[:-1], dr)],
                  dim=-1)
    return q, k, v, ckv, k_pe


def _attn_seq(p, cfg: ModelConfig, x):
    """Causal self-attention over x [B,S,d] (the reference's
    ``_attn_train``): (out, what a cache keeps of it: MLA's compressed
    latent and shared rope key, GQA's k and v)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.attention == "mla":
        q, k, v, ckv, k_pe = _mla_qkv_full(p, cfg, x, positions)
        kept = {"ckv": ckv, "kpe": k_pe}
    else:
        q, k, v = _gqa_qkv(p, cfg, x, positions)
        kept = {"k": k, "v": v}
    o = L.attention(q, k, v, causal=True, impl=cfg.attention_impl,
                    chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return L.dense(p, "attn/wo", o, "...hk,hkd->...d"), kept


def _attn_prefill(p, cfg: ModelConfig, x):
    """Returns (out, cache_entry_dict): MLA caches the compressed latent
    and the shared rope key (the whole point of MLA; the reference
    computes them twice, the same ops), GQA its K/V on the cache's
    grid."""
    out, kept = _attn_seq(p, cfg, x)
    if cfg.attention != "mla":
        kept = {n: _kv_store(cfg, t) for n, t in kept.items()}
    return out, kept


def _attn_decode(p, cfg: ModelConfig, x, cache_l, step: _Step,
                 attn_backend: Optional[str] = None):
    """x [B,d]; cache_l per-layer dict of views into the stacked cache;
    ``step`` the step's position index and int32 tensors.  Writes the
    new K/V row at ``step.row`` in place and returns (out, the same cache
    views)."""
    if cfg.attention == "mla":
        return _mla_decode(p, cfg, x, cache_l, step)
    row, posv, lengths = step
    q, k, v = _gqa_qkv(p, cfg, x, posv)
    kc, vc = cache_l["k"], cache_l["v"]
    kc.index_copy_(1, row, _kv_store(cfg, k)[:, None].to(kc.dtype))
    vc.index_copy_(1, row, _kv_store(cfg, v)[:, None].to(vc.dtype))
    o = L.decode_attention(q, _kv_load(cfg, kc), _kv_load(cfg, vc),
                           lengths, backend=attn_backend)
    out = L.dense(p, "attn/wo", o, "...hk,hkd->...d")
    return out, {"k": kc, "v": vc}


def _mla_decode(p, cfg: ModelConfig, x, cache_l, step: _Step):
    """Matrix-absorbed MLA decode over the compressed latent cache: the
    new latent and rope-key rows go in at ``step.row`` in place (one-lane
    ``index_copy_``; an int8 cache from ``cache_spec`` refuses the
    activation-dtype rows, as the reference's update does), the scores
    are float32 and masked by ``step.lengths``.  Returns (out, the same
    cache views)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    row, posv, lengths = step
    qh = _mla_q(p, cfg, x)
    q_nope, q_pe = qh[..., :dn], qh[..., dn:]
    q_pe = L.rope(q_pe, posv[:, None], cfg.rope_theta)
    ckv_new, kpe_new = _mla_latent(p, cfg, x)
    kpe_new = L.rope(kpe_new, posv, cfg.rope_theta)
    ckv, kpe = cache_l["ckv"], cache_l["kpe"]                # [B,Smax,*]
    ckv.index_copy_(1, row, ckv_new[:, None])
    kpe.index_copy_(1, row, kpe_new[:, None])
    # absorb W_UK into q
    q_abs = L.einsum("bhd,rhd->bhr", q_nope, L.W(p, "attn/wuk/w"))
    s = (torch.einsum("bhr,bsr->bhs", q_abs.to(F32), ckv.to(F32))
         + torch.einsum("bhk,bsk->bhs", q_pe.to(F32), kpe.to(F32)))
    s = s * ((dn + dr) ** -0.5)
    mask = torch.arange(ckv.shape[1], device=x.device)[None, :] \
        < lengths[:, None]
    s = torch.where(mask[:, None], s, -torch.inf)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(ckv.dtype), ckv)
    v_ctx = L.einsum("bhr,rhe->bhe", ctx, L.W(p, "attn/wuv/w"))
    out = L.dense(p, "attn/wo", v_ctx, "bhe,hed->bd")
    return out, {"ckv": ckv, "kpe": kpe}


# ---------------------------------------------------------------------------
# Block (attention + MLP)
# ---------------------------------------------------------------------------


def _block_apply(p, cfg: ModelConfig, x, mlp_kind: str, *, mode: str,
                 cache_l=None, step: Optional[_Step] = None,
                 attn_backend: Optional[str] = None):
    """Attention + GLU MLP (dense) or ``moe_ffn`` (decode: on ``h[:,
    None]``), pre-norm residual, in ``mode`` "train", "prefill" or
    "decode"; returns (x_out, the MoE aux loss (None for a dense block,
    whose reference aux is 0), new_cache_entry (None in "train"))."""
    h = L.rmsnorm(p, "ln_attn", x, cfg.norm_eps)
    new_cache = None
    if mode == "train":
        a = _attn_seq(p, cfg, h)[0]
    elif mode == "prefill":
        a, new_cache = _attn_prefill(p, cfg, h)
    else:
        a, new_cache = _attn_decode(p, cfg, h, cache_l, step,
                                    attn_backend=attn_backend)
    x = x + a
    h = L.rmsnorm(p, "ln_mlp", x, cfg.norm_eps)
    aux = None
    if mlp_kind == "dense":
        m = L.glu_mlp(p, "mlp", h, cfg.mlp_act)
    elif mode == "decode":
        m, aux = L.moe_ffn(p, "moe", h[:, None], cfg.moe, cfg.mlp_act)
        m = m[:, 0]
    else:
        m, aux = L.moe_ffn(p, "moe", h, cfg.moe, cfg.mlp_act)
    return x + m, aux, new_cache


# the weight products under the "dots" remat policy: GEMMs with no batch
# dimension, as JAX's ``checkpoint_dots_with_no_batch_dims`` keeps dots
# without one.  torch's einsum of an activation with a weight lowers to a
# ``bmm`` over a batch of 1; the bfloat16 head with a float32 result is
# ``mm.dtype``.  Batched products (attention's scores and values, the
# experts' [e, cap, d] GEMMs) are recomputed
_SAVED_MM = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype)


def _save_dots(ctx, op, *args, **kwargs):
    dot = op in _SAVED_MM or (op is torch.ops.aten.bmm.default
                              and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if dot
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``cfg.remat_policy`` on ``fn`` (the reference's ``jax.checkpoint``):
    "none" runs it as it is; "nothing" saves only its inputs and
    recomputes the rest in the backward; "dots" saves the outputs of its
    weight products as well (``_save_dots``).  The values and gradients
    are the same under all three.  Without autograd (serving) ``fn`` runs
    as it is.  No RNG state is kept: no forward here draws, and a CUDA
    graph capture refuses to read the generator's state."""
    if cfg.remat_policy == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, **kw)

    return run


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


def forward_train(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,V] float32, the MoE aux loss, a 0-d
    float32 tensor): every block under ``_remat``."""
    x = _embed_in(params, cfg, tokens)
    aux_total = torch.zeros((), dtype=F32, device=x.device)

    def block(mlp_kind):
        return _remat(lambda pp, xx: _block_apply(
            pp, cfg, xx, mlp_kind, mode="train")[:2], cfg)

    for i in range(_n_dense_first(cfg)):
        x, _ = block("dense")(subtree(params, f"layer{i}/"), x)
    fn = block(_mlp_kind(cfg))

    def body(x, p_l):
        x, aux = fn(p_l, x)
        return x, None if aux is None else {"aux": aux}

    x, auxes = maybe_scan(body, x, subtree(params, "layers/"))
    if auxes is not None:
        aux_total = aux_total + torch.sum(auxes["aux"])
    x = L.rmsnorm(params, "ln_f", x, cfg.norm_eps)
    logits = L.logits_head(params, x,
                           None if cfg.tie_embeddings else "head", "embed")
    return logits, aux_total


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch {"tokens", "labels" [B,S] [, "mask"]} -> (CE + MoE aux,
    {"ce", "moe_aux"})."""
    logits, aux = forward_train(params, cfg, batch["tokens"])
    ce = L.softmax_xent(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "moe_aux": aux}


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B,S] -> (cache, last-position logits [B,V] float32)."""
    x = _embed_in(params, cfg, tokens)
    head_caches = []
    for i in range(_n_dense_first(cfg)):
        x, _, c = _block_apply(subtree(params, f"layer{i}/"), cfg, x,
                               "dense", mode="prefill")
        head_caches.append(c)
    mlp_kind = _mlp_kind(cfg)

    def body(x, p_l):
        x, _, c = _block_apply(p_l, cfg, x, mlp_kind, mode="prefill")
        return x, c

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
        x, _, _ = _block_apply(subtree(params, f"layer{i}/"), cfg, x,
                               "dense", mode="decode", cache_l=cl,
                               step=step, attn_backend=attn_backend)
    mlp_kind = _mlp_kind(cfg)
    scan_cache = {k[len("scan/"):]: v for k, v in cache.items()
                  if k.startswith("scan/")}

    def body(x, xs):
        p_l, cl = xs
        x, _, _ = _block_apply(p_l, cfg, x, mlp_kind, mode="decode",
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
    """name -> (shape, dtype, logical axes).  MLA's ``ckv`` / ``kpe``
    take the reference's dtype here, int8 under ``kv_cache_dtype="int8"``,
    though its prefill emits them in the activation dtype and its decode
    keeps that (the reference's own disagreement, reproduced)."""
    dt = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    n_first = _n_dense_first(cfg)
    out: Dict[str, Tuple] = {}

    if cfg.attention == "mla":
        def entry(prefix, lead=()):
            la = ("layers",) if lead else ()
            out[f"{prefix}ckv"] = ((*lead, batch, smax, cfg.kv_lora_rank), dt,
                                   (*la, "batch", "kv_seq", "kv_lora"))
            out[f"{prefix}kpe"] = ((*lead, batch, smax, cfg.qk_rope_head_dim),
                                   dt, (*la, "batch", "kv_seq", "qk_dim"))
    else:
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
