"""Uniform Model API: one facade over the model families.

Port of ``repro/models/api.py`` for every family of the reference: the
``transformer`` family (GQA and MLA attention, dense and MoE MLPs), the
``ssm`` family (mamba2), the ``hybrid`` family (recurrentgemma), the
``encdec`` family (seamless-m4t) and the ``vlm`` family
(llama-3.2-vision).  Provides:
  init_params(cfg)          — concrete (on a device) or abstract (meta)
  quantize_for_serving      — int8 weights + per-tensor/per-layer scales
  loss_fn                   — the training entry point: (loss, metrics),
                              differentiable by autograd
  prefill / decode_step     — the serving entry points (encdec and vlm
                              take the batch's ``src_embeds`` /
                              ``image_embeds`` beside its tokens)
  input_specs               — ``meta`` tensors standing in for every
                              input of a shape's step
  cache_specs / grow_cache  — decode-cache shapes (encdec's cross entries
                              at ``src_len``), and growing a prefill cache
                              so decode can append; cache_pspec_axes
  analytic_param_count      — N for the 6·N·D roofline term
  model_flops               — the 6·N·D convention of a shape (2·N·D and
                              the attention's products for prefill and
                              decode)
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import (encdec, mamba2, recurrentgemma, transformer,
                                vlm)
from repro_torch.models.param import Registrar, fill_drawn

_FAMILIES: Dict[str, Any] = {"transformer": transformer, "ssm": mamba2,
                             "hybrid": recurrentgemma, "encdec": encdec,
                             "vlm": vlm}


def _family(cfg: ModelConfig):
    fam = _FAMILIES.get(cfg.family)
    if fam is None:
        raise ValueError(f"unknown model family {cfg.family!r}; the port "
                         f"serves {sorted(_FAMILIES)}")
    return fam


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, abstract: bool = False,
                device: DeviceLike = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[str, ...]]]:
    """Returns (params, logical_axes): the reference's draws from
    ``seed``, cast to ``cfg.param_dtype`` on ``device`` (``None`` means
    ``cuda``); ``abstract`` gives ``meta`` tensors and draws nothing.
    The concrete parameters are filled in a pool of up to 8 threads, each
    chunk by chunk (``param.fill_drawn``: the host holds one chunk a
    parameter); each has its own generator, so the values are a
    Registrar's."""
    reg = Registrar(abstract=True, seed=seed,
                    dtype=getattr(torch, cfg.param_dtype))
    _family(cfg).init_params(reg, cfg)
    if abstract:
        return reg.params, reg.axes
    dev = resolve_device(device)
    params = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
              for k, v in reg.params.items()}
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for job in [pool.submit(fill_drawn, v, k, *reg.inits[k], seed)
                    for k, v in params.items()]:
            job.result()
    return params, reg.axes


_QUANT_SKIP = ("norm", "scale", "router", "gate_attn", "gate_mlp", "lam",
               "A_log", "dt_bias", "/b")


def quantize_for_serving(cfg: ModelConfig, params: Dict[str, Any],
                         axes: Dict[str, Tuple[str, ...]]
                         ) -> Tuple[Dict[str, Any], Dict[str, Tuple[str, ...]]]:
    """FENIX Model Engine INT8 applied to LM weights (serve path only).

    Matmul weights become int8 + a float32 per-tensor scale (per-layer for
    stacked weights), computed in float32 as the reference does, so the
    int8 values are equal.  A stacked weight is quantized one layer at a
    time (a float32 copy of the whole of qwen2-moe-a2.7b's experts would
    not fit beside them).  ``meta`` tensors give ``meta`` results.
    """
    new_p, new_ax = {}, {}
    for k, v in params.items():
        new_p[k], new_ax[k] = v, axes[k]
        if v.dim() < 2 or any(s in k for s in _QUANT_SKIP):
            continue
        if not (k.endswith("/w") or k.endswith("/table")
                or "/experts/" in k):
            continue
        stacked = axes[k][0] == "layers"
        sshape = (v.shape[0],) if stacked else ()
        sax = ("layers",) if stacked else ()
        if v.is_meta:
            new_p[k] = torch.empty(v.shape, dtype=torch.int8, device="meta")
            new_p[f"{k}_scale"] = torch.empty(sshape, dtype=torch.float32,
                                              device="meta")
        else:
            q = torch.empty(v.shape, dtype=torch.int8, device=v.device)
            scales = []
            for dst, src in (zip(q, v) if stacked else ((q, v),)):
                w = src.to(torch.float32)
                scale = torch.clamp_min(w.abs().amax(), 1e-8) / 127.0
                dst.copy_(torch.clamp(torch.round(w / scale), -127, 127))
                scales.append(scale)
            new_p[k] = q
            new_p[f"{k}_scale"] = torch.stack(scales) if stacked \
                else scales[0]
        new_ax[f"{k}_scale"] = sax
    return new_p, new_ax


def loss_fn(params, cfg: ModelConfig, batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch {"tokens", "labels": [B,S] [, "mask"]} (encdec: +
    ``src_embeds`` [B,S_src,d]; vlm: + ``image_embeds`` [B,S_img,d]) ->
    (the loss, a 0-d float32 tensor, and its metrics: ``ce`` for every
    family, ``moe_aux`` too for the transformer family); gradients by
    autograd (``train.optimizer.value_and_grad``)."""
    return _family(cfg).loss_fn(params, cfg, batch)


def prefill(params, cfg: ModelConfig, batch):
    """batch {"tokens": [B,S]} (encdec: + ``src_embeds`` [B,S_src,d]; vlm:
    + ``image_embeds`` [B,S_img,d]) -> (cache, last-position logits
    [B,V])."""
    fam = _family(cfg)
    if cfg.family in ("encdec", "vlm"):
        return fam.prefill(params, cfg, batch)
    return fam.prefill(params, cfg, batch["tokens"])


def decode_step(params, cfg: ModelConfig, cache, tokens,
                attn_backend: Optional[str] = None):
    """One token per sequence; ``attn_backend`` ("cuda" | "ref" | None
    for the device's default) selects the decode-attention kernel.
    Consumes ``cache``: its K/V tensors take the new rows in place at
    ``pos`` (a 0-d int32 device tensor; the hybrid's ring at ``pos %
    window``) and its recurrent states (entries without a ``kv_seq``
    axis) the new states, and the returned cache holds the same tensors
    with ``pos + 1`` as a new tensor.  Reads nothing back to the host, so
    every step is the same program (a CUDA graph can replay it)."""
    return _family(cfg).decode_step(params, cfg, cache, tokens,
                                    attn_backend=attn_backend)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, smax: int,
                src_len: Optional[int] = None
                ) -> Dict[str, Tuple[Tuple[int, ...], Any, Tuple[str, ...]]]:
    """name -> (shape, dtype, logical axes) of the decode cache; encdec's
    cross entries have ``src_len`` rows (default ``smax``)."""
    fam = _family(cfg)
    if cfg.family == "encdec":
        return fam.cache_spec(cfg, batch, smax,
                              src_len=src_len if src_len else smax)
    return fam.cache_spec(cfg, batch, smax)


def grow_cache(cfg: ModelConfig, cache: Dict[str, Any], batch: int,
               old_smax: int, new_smax: int, src_len: Optional[int] = None,
               out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Zero-pad the kv_seq axes of a prefill cache so decode can append.

    Identifies the sequence axis per entry by diffing cache_specs at the two
    lengths (at one ``src_len``); the grown entries are new tensors on the
    cache's device.  Entries whose shape does not depend on the length
    (recurrent states and conv tails, the hybrid's ring, the encdec and
    vlm cross K/V, ``pos``) are kept as they are.
    Given ``out`` (a grown cache of these shapes from an earlier call),
    the entries are written into its tensors instead, which keep their
    addresses (the buffers a captured decode step reads).  ``pos``, the
    next position as a 0-d int32 device tensor, is carried over.
    """
    old = cache_specs(cfg, batch, old_smax, src_len=src_len)
    new = cache_specs(cfg, batch, new_smax, src_len=src_len)
    res = dict(cache) if out is None else out
    for k, (oshp, _dt, _ax) in old.items():
        if k not in cache:
            continue
        arr = cache[k]
        if out is None:
            nshp = new[k][0]
            if oshp == nshp:
                continue
            res[k] = grown = arr.new_zeros(nshp[len(nshp) - arr.dim():])
        else:
            grown = out[k]
            for d, (n_old, n_new) in enumerate(zip(arr.shape, grown.shape)):
                if n_new != n_old:
                    grown.narrow(d, n_old, n_new - n_old).zero_()
        grown[tuple(slice(0, n) for n in arr.shape)] = arr
    return res


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors standing in for the step function's inputs (the
    reference's ``ShapeDtypeStruct``s):

    train  -> {tokens, labels [, src_embeds | image_embeds]}
    prefill-> {tokens [, src_embeds | image_embeds]}
    decode -> {tokens [B], cache: {...}}
    """
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.activation_dtype)

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = meta((b, s), torch.int32)
        if shape.kind == "train":
            out["labels"] = meta((b, s), torch.int32)
        if cfg.family == "encdec":
            out["src_embeds"] = meta((b, s, cfg.d_model), act)
        if cfg.family == "vlm":
            out["image_embeds"] = meta((b, cfg.num_image_tokens,
                                        cfg.d_model), act)
        return out
    # decode: single token + KV cache of seq_len
    out["tokens"] = meta((b,), torch.int32)
    out["cache"] = {name: meta(shp, dt) for name, (shp, dt, _ax)
                    in cache_specs(cfg, b, s).items()}
    return out


def cache_pspec_axes(cfg: ModelConfig, batch: int, smax: int
                     ) -> Dict[str, Tuple[str, ...]]:
    """name -> the logical axes of each decode-cache entry."""
    return {k: ax for k, (shp, dt, ax) in
            cache_specs(cfg, batch, smax).items()}


# ---------------------------------------------------------------------------
# Analytic parameter counts (for MODEL_FLOPS = 6*N*D)
# ---------------------------------------------------------------------------


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Matmul-participating parameters per token (the transformer
    family, MoE and MLA included; ssm; hybrid; encdec; vlm): pure
    arithmetic on the config.

    Excludes the embedding *gather* (not a matmul); includes the LM head
    (tied or not — the logits matmul runs either way).  For MoE with
    active_only=True, routed experts count top_k of num_experts.
    """
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attn_gqa() -> int:
        return d * h * dh + 2 * d * hkv * dh + h * dh * d

    def attn_mla() -> int:
        dn, dr, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        n = 0
        if cfg.q_lora_rank:
            n += d * cfg.q_lora_rank + cfg.q_lora_rank * h * (dn + dr)
        else:
            n += d * h * (dn + dr)
        n += d * r + d * dr + r * h * dn + r * h * cfg.v_head_dim
        n += h * cfg.v_head_dim * d
        return n

    def mlp_dense(ff) -> int:
        return 3 * d * ff

    _family(cfg)
    total = 0
    if cfg.family == "transformer":
        attn = attn_mla() if cfg.attention == "mla" else attn_gqa()
        m = cfg.moe
        if m.num_experts:
            n_first = m.first_dense_layers
            total += n_first * (attn + mlp_dense(m.first_dense_d_ff))
            n_moe = cfg.num_layers - n_first
            e_cnt = m.top_k if active_only else m.num_experts
            per = (attn + d * m.num_experts            # router
                   + e_cnt * 3 * d * m.expert_d_ff
                   + (3 * d * m.shared_d_ff if m.num_shared_experts else 0))
            total += n_moe * per
        else:
            total += cfg.num_layers * (attn + mlp_dense(f))
    elif cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * d
        gn = s.n_groups * s.d_state
        nh = d_in // s.head_dim
        total += cfg.num_layers * (2 * d * d_in + 2 * d * gn + d * nh
                                   + d_in * d)
    elif cfg.family == "hybrid":
        w = cfg.hybrid.lru_width or d
        pat = cfg.hybrid.pattern
        n_rec = sum(pat[i % len(pat)] == "recurrent"
                    for i in range(cfg.num_layers))
        n_att = cfg.num_layers - n_rec
        rec = 2 * d * w + 2 * (w * w) // 16 + w * d
        total += n_rec * rec + n_att * attn_gqa()
        total += cfg.num_layers * mlp_dense(f)
    elif cfg.family == "encdec":
        enc = cfg.num_encoder_layers * (attn_gqa() + mlp_dense(f))
        dec = cfg.num_decoder_layers * (2 * attn_gqa() + mlp_dense(f))
        total += enc + dec
    elif cfg.family == "vlm":
        per = cfg.cross_attn_every
        n_super = cfg.num_layers // per
        total += n_super * ((per - 1) * (attn_gqa() + mlp_dense(f))
                            + attn_gqa() + mlp_dense(f))
    total += d * v  # logits head matmul
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D convention. For decode shapes D = global_batch (1 token each);
    attention-over-cache FLOPs are additionally included (2*bytes-free term:
    2 * B * S * kv_width) since they dominate long-context decode."""
    n = analytic_param_count(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        flops = 2.0 * n * shape.global_batch * shape.seq_len
        return flops + _attn_flops(cfg, shape.global_batch, shape.seq_len)
    # decode: one token per sequence
    flops = 2.0 * n * shape.global_batch
    return flops + _decode_attn_flops(cfg, shape.global_batch,
                                      shape.seq_len)


def _n_attention_layers(cfg: ModelConfig) -> int:
    pat = cfg.hybrid.pattern
    return sum(pat[i % len(pat)] != "recurrent"
               for i in range(cfg.num_layers))


def _attn_flops(cfg: ModelConfig, b: int, s: int) -> float:
    """Causal self-attention matmul FLOPs (scores + combine), per model."""
    if cfg.family == "ssm":
        return 0.0
    h, dh = cfg.num_heads, cfg.head_dim
    if cfg.attention == "mla":
        dh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    full = 2.0 * 2.0 * b * h * dh * s * s / 2.0      # causal half
    if cfg.family == "hybrid":
        win = cfg.hybrid.attention_window
        per = 2.0 * 2.0 * b * h * dh * s * min(win, s)
        return _n_attention_layers(cfg) * per
    n_layers = cfg.num_layers if cfg.family != "encdec" \
        else cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    return n_layers * full


def _decode_attn_flops(cfg: ModelConfig, b: int, s: int) -> float:
    if cfg.family == "ssm":
        s_cfg = cfg.ssm
        d_in = s_cfg.expand * cfg.d_model
        nh = d_in // s_cfg.head_dim
        per = 2.0 * 2.0 * b * nh * s_cfg.head_dim * s_cfg.d_state
        return cfg.num_layers * per
    h, dh = cfg.num_heads, cfg.head_dim
    if cfg.attention == "mla":
        # absorbed decode: q_abs@ckv + probs@ckv over rank R
        r = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        return cfg.num_layers * 2.0 * 2.0 * b * cfg.num_heads * r * s
    if cfg.family == "hybrid":
        win = cfg.hybrid.attention_window
        n_att = _n_attention_layers(cfg)
        n_rec = cfg.num_layers - n_att
        w = cfg.hybrid.lru_width or cfg.d_model
        return (n_att * 2.0 * 2.0 * b * h * dh * min(win, s)
                + n_rec * 2.0 * b * w)
    n_layers = cfg.num_layers if cfg.family != "encdec" \
        else cfg.num_decoder_layers
    per = 2.0 * 2.0 * b * h * dh * s
    if cfg.family == "encdec":
        per *= 2  # self + cross
    if cfg.family == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_every
        per_cross = 2.0 * 2.0 * b * h * dh * cfg.num_image_tokens
        return (cfg.num_layers - n_cross) * per + n_cross * per_cross
    return n_layers * per
