"""The port's hybrid family (``models/recurrentgemma.py``,
``recurrentgemma-9b``) against the JAX package on the CPU, on the
config's ``reduced()`` (5 layers: one (r, r, a) superblock and an (r, r)
tail; 4 query heads over 1 KV head; a 32-slot attention ring), and the
plain decode attention at the full width's group of 16.

Tolerances, each relative to the reference's largest magnitude:
- float32: 1e-5 (the same float32 operations, summed in another order).
- bfloat16, against the scanned reference and against the unrolled one
  (``scan_layers=False``): 3e-2.  The unrolled loop's measured reason:
  the GeGLU gates (``gelu``, op for op as JAX writes it) differ from XLA's
  fused bfloat16 ``gelu`` in 0.35% of outputs (XLA's tanh; the transformer
  tests measure the same, tests/test_torch_lm.py), and every one of the 5
  layers applies two of them (the recurrent gate and the MLP); the
  unrolled reference's logits and caches measured 1.5e-2 to 3.2e-2 from
  the port's over 8 steps at 20- to 70-token prompts.  Every other op of a
  recurrent block is bit for bit the reference's
  (``test_recurrent_block_ops_match``).
- int8 weights: 5e-2 against the unrolled reference.  Measured: 3.6e-2
  of the largest logit and 3.8e-2 of a cache's largest value at a
  45-token prompt (4.4e-2 at 20 tokens).  The raw int8 ``conv/w`` (the
  reference's quirk, reproduced) multiplies the recurrent path by
  unscaled int8 values, so the GeGLU's bfloat16 flips above weigh more
  against the int8 model's small logits (largest 0.5).  The scanned
  reference is no yardstick there: inside its fused layer body XLA
  keeps a dequantized weight (``w.astype(bf16) * scale``) in float32
  where the op-by-op reference rounds it (1e-1 from either).

The reference's decode step is jitted here, as its serving engine jits
it; the unrolled reference runs op by op.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_same, lm_run_both,
                           to_numpy)
from repro.configs import get_config as jax_config
from repro.kernels.decode_attention.ref import decode_attention_ref as jref
from repro.models import api as japi
from repro.models import param as jparam
from repro.models import recurrentgemma as JR
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.models import api
from repro_torch.models import layers as TL
from repro_torch.models import recurrentgemma as TR
from repro_torch.models.param import associative_scan, params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServingEngine

ARCH = "recurrentgemma-9b"
F32_OVER = dict(param_dtype="float32", activation_dtype="float32")
WIN = 32   # the reduced config's attention window (ring slots)


def _both(reduced=True, **over):
    return (dataclasses.replace(jax_config(ARCH, reduced=reduced), **over),
            dataclasses.replace(get_config(ARCH, reduced=reduced), **over))


def _converted(jp):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                             "cpu")


def _pair(rng, shape, dtype, scale=1.0):
    j = jnp.asarray(rng.normal(0, scale, shape), getattr(jnp, dtype))
    return j, params_from_numpy({"x": np.asarray(j)}, "cpu")["x"]


def _caches_close(jc, tc, tol, where):
    for k in jc:
        if k == "pos":
            continue
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
        assert tc[k].shape == jc[k].shape, k
        assert_close(to_numpy(jc[k]).astype(np.float32), tc[k].float(), tol,
                     f"{where} {k}")


# -- config, counts, draws ----------------------------------------------------


def test_config_counts_and_specs_match():
    for reduced in (True, False):
        cj, ct = _both(reduced)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
        assert api.analytic_param_count(ct) == japi.analytic_param_count(cj)
        assert ct.param_count() == cj.param_count()
        js, ts = japi.cache_specs(cj, 4, 100), api.cache_specs(ct, 4, 100)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert js[k][0] == ts[k][0] and js[k][2] == ts[k][2], k
            assert str(ts[k][1]) == f"torch.{jnp.dtype(js[k][1]).name}", k
    full = get_config(ARCH)
    assert full.sub_quadratic and full.num_heads // full.num_kv_heads == 16
    assert full.head_dim == 256
    # 12 superblocks (r, r, a) + an (r, r) tail; the ring's K/V have a
    # kv_seq axis of window slots, whatever the length asked for
    specs = api.cache_specs(full, 8, 4128)
    assert specs["sb/l2/k"][0] == (12, 8, 2048, 1, 256)
    assert "tail/l1/h" in specs and "tail/l2/k" not in specs
    assert specs == api.cache_specs(full, 8, 600_000)


def test_registrar_draws_match(monkeypatch):
    """The port's Registrar makes the reference's draws: bit for bit after
    the bfloat16 cast, equal as float64 before it (the stacked ``sb/``
    and the unstacked ``tail/`` layers)."""
    cj, ct = _both()
    jp, jax_axes = japi.init_params(cj, seed=3)
    tp, axes = api.init_params(ct, seed=3, device="cpu")
    assert sorted(jp) == sorted(tp) and axes == jax_axes
    assert tp["sb/l0/wa/w"].shape == (1, 16, 4, 4)
    assert tp["tail/l1/conv/w"].shape == (4, 64)
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype)), k
        assert_same(np.asarray(jp[k]).view(np.uint16)
                    if jp[k].dtype == jnp.bfloat16 else jp[k],
                    tp[k].view(torch.int16).numpy().view(np.uint16)
                    if tp[k].dtype == torch.bfloat16 else tp[k], k)
    monkeypatch.setattr(jparam, "jnp", SimpleNamespace(
        asarray=lambda a, dtype=None: a, bfloat16=jnp.bfloat16))
    reg_j = jparam.Registrar(seed=3)
    JR.init_params(reg_j, cj)
    reg_t = api.Registrar(seed=3, dtype=torch.float64)
    TR.init_params(reg_t, ct)
    for k, v in reg_j.params.items():
        got = reg_t.params[k].numpy()
        assert np.array_equal(v.astype(got.dtype), got), k


# -- the RG-LRU ---------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 100])
def test_associative_scan_matches_jax(s):
    """The port of ``jax.lax.associative_scan`` (JAX's odd/even recursion)
    on the RG-LRU's combine, along axis 1 of [2, S, 8] float32: within
    1e-6 of the reference's largest value (the same combines; XLA may
    fuse a multiply-add), and equal to the sequential recurrence."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = rng.normal(0, 1, (2, s, 8)).astype(np.float32)
    _, jh = jax.lax.associative_scan(_jax_combine, (jnp.asarray(a),
                                                    jnp.asarray(b)), axis=1)
    _, th = associative_scan(TR._lru_combine, (torch.from_numpy(a),
                                               torch.from_numpy(b)), axis=1)
    assert th.shape == (2, s, 8)
    assert_close(jh, th, 1e-6, f"h at S={s}")
    seq = np.zeros((2, 8), np.float32)
    for t in range(s):
        seq = a[:, t] * seq + b[:, t]
        assert np.allclose(th[:, t].numpy(), seq, rtol=1e-5, atol=1e-5)


def _jax_combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def test_softplus_is_jax_softplus():
    """``layers.softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``)
    over float32 inputs from -100 to 100, NaN and the infinities, where
    ``F.softplus`` returns x itself above 20."""
    x = np.linspace(-100, 100, 20001, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    assert_close(want, TL.softplus(torch.from_numpy(x)), 1e-7)
    special = np.array([np.nan, np.inf, -np.inf], np.float32)
    assert np.array_equal(np.asarray(jax.nn.softplus(jnp.asarray(special))),
                          TL.softplus(torch.from_numpy(special)).numpy(),
                          equal_nan=True)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_seq_matches(with_h0):
    """``_rg_lru_seq`` over 37 steps, with and without a carried-in
    state: y and the last state within 1e-5 (float32)."""
    cj, ct = _both(**F32_OVER)
    jp, _ = japi.init_params(cj, seed=1)
    tp = _converted(jp)
    p_j = {k[len("tail/l0/"):]: v for k, v in jp.items()
           if k.startswith("tail/l0/")}
    p_t = {k[len("tail/l0/"):]: v for k, v in tp.items()
           if k.startswith("tail/l0/")}
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng, (2, 37, 64), "float32")
    jh0, th0 = _pair(rng, (2, 64), "float32") if with_h0 else (None, None)
    jy, jh = JR._rg_lru_seq(p_j, jx, h0=jh0)
    ty, th = TR._rg_lru_seq(p_t, tx, h0=th0)
    assert_close(jy, ty, 1e-5, "y")
    assert_close(jh, th, 1e-5, "h_last")


def test_recurrent_block_seq_with_state_matches():
    """``_recurrent_block_seq`` carrying a conv tail and a state in
    (float32): the output and the new tail and state within 1e-5."""
    cj, ct = _both(**F32_OVER)
    jp, _ = japi.init_params(cj, seed=2)
    tp = _converted(jp)
    p_j = {k[len("tail/l1/"):]: v for k, v in jp.items()
           if k.startswith("tail/l1/")}
    p_t = {k[len("tail/l1/"):]: v for k, v in tp.items()
           if k.startswith("tail/l1/")}
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (2, 9, 64), "float32")
    jc, tc = _pair(rng, (2, 3, 64), "float32")
    jh, th = _pair(rng, (2, 64), "float32")
    jy, (jc2, jh2) = JR._recurrent_block_seq(p_j, cj, jx, state=(jc, jh))
    ty, (tc2, th2) = TR._recurrent_block_seq(p_t, ct, tx, state=(tc, th))
    for want, got, what in ((jy, ty, "y"), (jc2, tc2, "conv"),
                            (jh2, th2, "h")):
        assert_close(want, got, 1e-5, what)


def test_recurrent_block_ops_match():
    """bfloat16 recurrent block, op by op: every op bit for bit the
    reference's but the GeGLU gate's ``gelu`` (XLA's bfloat16 tanh)."""
    cj, ct = _both()
    jp, _ = japi.init_params(cj, seed=0)
    tp = _converted(jp)
    p_j = {k[len("tail/l0/"):]: v for k, v in jp.items()
           if k.startswith("tail/l0/")}
    p_t = {k[len("tail/l0/"):]: v for k, v in tp.items()
           if k.startswith("tail/l0/")}
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (2, 20, 64), "bfloat16")
    from repro.models import layers as JL
    from repro.models.mamba2 import _causal_conv as jconv

    hx_j, hx_t = JL.rmsnorm(p_j, "ln", jx), TL.rmsnorm(p_t, "ln", tx)
    u_j = JL.dense(p_j, "win", hx_j, "...d,dw->...w")
    u_t = TL.dense(p_t, "win", hx_t, "...d,dw->...w")
    uc_j = jconv(u_j, p_j["conv/w"], p_j["conv/b"])
    uc_t = TR._causal_conv(u_t, p_t["conv/w"], p_t["conv/b"])
    for want, got in ((hx_j, hx_t), (u_j, u_t), (uc_j, uc_t),
                      (JR._block_diag(p_j, "wa", uc_j),
                       TR._block_diag(p_t, "wa", uc_t)),
                      (JR._rg_lru_seq(p_j, uc_j)[0],
                       TR._rg_lru_seq(p_t, uc_t)[0])):
        assert_same(np.asarray(want, np.float32), got.float())


# -- the model ----------------------------------------------------------------


# prompts below, at and above the 32-slot window (45 % 32 != 0: the
# prefill's roll is not the identity); 8 steps wrap the ring from 32 on
CASES = [("float32", 20), ("float32", 32), ("float32", 45), ("bf16", 45),
         ("bf16_unrolled", 45)]
VARIANTS = {"float32": (F32_OVER, 1e-5), "bf16": ({}, 3e-2),
            "bf16_unrolled": (dict(scan_layers=False), 3e-2)}


@pytest.mark.parametrize("variant,s", CASES)
def test_prefill_decode_match(variant, s):
    """Prefill and 8 greedy decode steps: the logits of every call and
    the final caches (ring K/V in slot order, conv tails, states) within
    the module docstring's tolerances, ``pos`` a 0-d device tensor
    throughout; in float32 the port's ``ServingEngine.generate`` gives the
    reference's greedy tokens."""
    over, tol = VARIANTS[variant]
    cfg_j, cfg_t = _both(**over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks = np.random.default_rng(s).integers(0, cfg_j.vocab_size, (2, s)
                                             ).astype(np.int32)
    out, (jc, tc), greedy = lm_run_both(cfg_j, cfg_t, jp, tp, toks)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, tol, f"{variant} S={s} call {i}")
    _caches_close(jc, tc, tol, f"{variant} S={s}")
    if variant == "float32":
        eng = ServingEngine(cfg_t, tp, ServeConfig(max_new_tokens=9),
                            device="cpu")
        assert np.array_equal(eng.generate({"tokens": toks})["tokens"],
                              greedy)


# (prompt, segment): a cut inside the window (24 < 32: the second
# segment's rows reach back across it), segments shorter than the window
# (three: 16, 16, 13), and three segments longer than it (40, 40, 20)
SEGMENTS = [(45, 24), (45, 16), (100, 40)]


@pytest.mark.parametrize("variant", ["float32", "bf16"])
@pytest.mark.parametrize("s,seg", SEGMENTS)
def test_segmented_prefill_matches(variant, s, seg, monkeypatch):
    """A prompt longer than ``PREFILL_TOKENS`` (patched small: a segment
    of ``seg`` positions at batch 2) runs each layer in segments, carrying
    the recurrent state and the attention's last ``window - 1`` K/V rows;
    the logits, then 4 greedy decode steps on its cache, and the final
    caches against the reference's whole-prompt prefill, within the
    tolerance: float32 1e-5 (the scan's tree and the attention's blocks
    differ by segment, rounding only; measured 3.4e-6); bfloat16 5e-2,
    the family's 3e-2 (module docstring) plus the segments' own bfloat16
    roundings of the attention output and the carried state (measured
    3.4e-2 of a largest logit of 0.52 at the 24-token cut, 2.6e-2 at the
    others).  The same against the port's own whole-prompt prefill."""
    over, _ = VARIANTS[variant]
    tol = 1e-5 if variant == "float32" else 5e-2
    cfg_j, cfg_t = _both(**over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks = np.random.default_rng(s + seg).integers(
        0, cfg_j.vocab_size, (2, s)).astype(np.int32)
    _, whole = api.prefill(tp, cfg_t, {"tokens": torch.from_numpy(toks)})
    starts = []
    attn_block = TR._attn_block_seq

    def spy(p, cfg, x, start=0, prefix=None):
        starts.append((start, None if prefix is None
                       else prefix[0].shape[1]))
        return attn_block(p, cfg, x, start=start, prefix=prefix)

    monkeypatch.setattr(TR, "_attn_block_seq", spy)
    monkeypatch.setattr(TR, "PREFILL_TOKENS", 2 * seg)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jp, tp, toks, steps=4)
    # one attention layer (sb/l2); each segment's key prefix is the
    # window - 1 positions before it, or all of them
    assert starts == [(lo, min(lo, WIN - 1) if lo else None)
                      for lo in range(0, s, seg)]
    for i, (want, got) in enumerate(out):
        assert_close(want, got, tol, f"{variant} S={s} seg={seg} call {i}")
    assert_close(out[0][1], whole, tol, "segmented against whole, port")
    _caches_close(jc, tc, tol, f"{variant} S={s} seg={seg}")


def test_int8_serving_matches_reading_conv_w_raw():
    """``quantize_for_serving`` quantizes the recurrent blocks' ``conv/w``
    and both packages read it raw (the block-diagonal gates through
    ``W()``); the port's int8 model is within 5e-2 (module docstring) of
    the reference's, unrolled over layers, over a 45-token prefill and 8
    steps past the ring's wrap."""
    cfg_j, cfg_t = _both(scan_layers=False)
    jp, jax_axes = japi.init_params(cfg_j, seed=0)
    tp, axes = api.init_params(cfg_t, seed=0, device="cpu")
    jq, jqa = japi.quantize_for_serving(cfg_j, jp, jax_axes)
    tq, tqa = api.quantize_for_serving(cfg_t, tp, axes)
    assert tqa == jqa and sorted(tq) == sorted(jq)
    for k in ("sb/l0/conv/w", "tail/l1/conv/w", "sb/l0/wa/w"):
        assert tq[k].dtype == torch.int8 and f"{k}_scale" in tq, k
    assert tq["sb/l0/lam"].dtype == torch.float32
    for k in jq:
        if jq[k].dtype == jnp.bfloat16:
            assert_same(np.asarray(jq[k]).view(np.uint16),
                        tq[k].view(torch.int16).numpy().view(np.uint16), k)
        else:
            assert_same(jq[k], tq[k], k)
    toks = np.random.default_rng(9).integers(0, cfg_j.vocab_size, (2, 45)
                                             ).astype(np.int32)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jq, _converted(jq), toks)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, 5e-2, f"int8 call {i}")
    _caches_close(jc, tc, 5e-2, "int8")


def test_ring_decode_writes_one_slot_in_place():
    """A decode step at position p writes ring slot p % 32 of every
    attention layer in place, and no other; the recurrent states and
    conv tails are written in place too.  Across the wrap (p = 45 -> slot
    13) the keys are min(p + 1, 32)."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, ct.vocab_size, (2, 45)).astype(np.int32))
    cache, _ = api.prefill(tp, ct, {"tokens": toks})
    cache = api.grow_cache(ct, cache, 2, 45, 50)
    before = {k: v.clone() for k, v in cache.items()}
    new, _ = api.decode_step(tp, ct, cache, toks[:, 0])
    changed = (new["sb/l2/k"] != before["sb/l2/k"]).flatten(3).any(-1)
    assert new["sb/l2/k"] is cache["sb/l2/k"]
    assert changed[:, :, 45 % WIN].all()
    changed[:, :, 45 % WIN] = False
    assert not changed.any()
    for k in ("sb/l0/h", "sb/l1/conv", "tail/l1/h"):
        assert new[k] is cache[k] and not torch.equal(new[k], before[k]), k
    assert int(new["pos"]) == 46 and int(cache["pos"]) == 45


# -- decode attention at the full width's group -------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_attention_at_group_16(dtype):
    """recurrentgemma-9b's decode shape (16 query heads over one KV head,
    D 256) on a 200-slot ring with ragged key counts (a full ring, 1,
    73): the port's plain version against the reference's
    ``decode_attention_ref`` within 1e-5 (float32) / 1e-2 (one bfloat16
    ulp of the output)."""
    rng = np.random.default_rng(16)
    jq, tq = _pair(rng, (3, 16, 256), dtype)
    jk, tk = _pair(rng, (3, 200, 1, 256), dtype)
    jv, tv = _pair(rng, (3, 200, 1, 256), dtype)
    lens = np.array([200, 1, 73], np.int32)
    want = jref(jq, jk, jv, jnp.asarray(lens))
    got = attn_ops.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                    backend="ref")
    assert got.shape == (3, 16, 256) and got.dtype == tv.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert_close(np.asarray(want, np.float32), got.float(), tol)
