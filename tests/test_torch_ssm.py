"""The port's ssm family (``models/mamba2.py``, ``mamba2-370m``) against
the JAX package on the CPU, on the config's ``reduced()``.

Inputs are made with numpy from a seed; the JAX parameters go through
the converter (``params_from_numpy``), so both sides hold the same bits.

Tolerances, each relative to the reference's largest magnitude:
- float32: 1e-5 (the same float32 operations, summed in another order).
- bfloat16 with the reference's ``lax.scan`` over layers: 3e-2 (XLA
  fuses the scanned layer body and keeps float32 between fused
  elementwise ops, as for the transformers, tests/test_torch_lm.py).
- bfloat16, the reference unrolled over layers (``scan_layers=False``,
  each op rounded as eager PyTorch rounds it): 1e-2.  Measured: the
  first layer is bit for bit the reference's, and each block's SSD core
  is too (``test_ssd_chunked_matches``), but in the second layer's
  ``rmsnorm`` a float32 mean summed in another order puts one bfloat16
  element on the other side of a rounding boundary (0.0078 at a
  magnitude of 3.4), and the state carries it: 3.6e-3 of the largest
  logit at a 17-token prompt.
- int8 weights: 1e-5 against the unrolled reference (measured 2.4e-7).
  The scanned reference is no yardstick there: inside its fused layer
  body XLA keeps a dequantized weight (``w.astype(bf16) * scale``) in
  float32 where the op-by-op reference rounds it to bfloat16, which moves
  the logits by up to 1e-2.

The reference's decode step is jitted here, as its serving engine jits
it (its ``lax.scan`` over layers would otherwise compile again at every
call); the unrolled reference runs op by op.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_same, lm_run_both,
                           to_numpy)
from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import mamba2 as JM
from repro.models import param as jparam
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models import mamba2 as TM
from repro_torch.models.param import params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServingEngine

ARCH = "mamba2-370m"
F32_OVER = dict(param_dtype="float32", activation_dtype="float32")


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
            assert "kv_seq" not in ts[k][2]
    assert get_config(ARCH).sub_quadratic


def test_registrar_draws_match(monkeypatch):
    """The port's Registrar makes the reference's draws: bit for bit after
    the bfloat16 cast, equal as float64 before it; the abstract params
    have the concrete shapes."""
    cj, ct = _both()
    jp, jax_axes = japi.init_params(cj, seed=3)
    tp, axes = api.init_params(ct, seed=3, device="cpu")
    assert sorted(jp) == sorted(tp) and axes == jax_axes
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype)), k
        assert_same(np.asarray(jp[k]).view(np.uint16)
                    if jp[k].dtype == jnp.bfloat16 else jp[k],
                    tp[k].view(torch.int16).numpy().view(np.uint16)
                    if tp[k].dtype == torch.bfloat16 else tp[k], k)
    meta, _ = api.init_params(ct, abstract=True)
    assert {k: v.shape for k, v in meta.items()} == \
        {k: v.shape for k, v in tp.items()}
    monkeypatch.setattr(jparam, "jnp", SimpleNamespace(
        asarray=lambda a, dtype=None: a, bfloat16=jnp.bfloat16))
    reg_j = jparam.Registrar(seed=3)
    JM.init_params(reg_j, cj)
    reg_t = api.Registrar(seed=3, dtype=torch.float64)
    TM.init_params(reg_t, ct)
    for k, v in reg_j.params.items():
        got = reg_t.params[k].numpy()
        assert np.array_equal(v.astype(got.dtype), got), k


# -- the SSD core -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches(dtype):
    """Bit for bit: the same shifted products and sums, in the
    reference's order; an int8 ``w`` (int8 serving reads ``conv/w`` raw)
    promotes as JAX promotes it."""
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 19, 24), dtype)
    jw, tw = _pair(rng, (4, 24), dtype, 0.5)
    jb, tb = _pair(rng, (24,), dtype)
    assert_same(np.asarray(JM._causal_conv(jx, jw, jb), np.float32),
                TM._causal_conv(tx, tw, tb).float())
    w8 = rng.integers(-127, 128, (4, 24)).astype(np.int8)
    want = JM._causal_conv(jx, jnp.asarray(w8), jb)
    got = TM._causal_conv(tx, torch.from_numpy(w8), tb)
    assert got.dtype == tx.dtype
    assert_same(np.asarray(want, np.float32), got.float())


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches(dtype, with_h0):
    """``_ssd_chunked`` on 45 tokens with chunks of 32 (the last chunk
    padded), with and without a carried-in state: the outputs and the
    last state within 1e-5 of the reference's (float32 sums in another
    order; in bfloat16 the same roundings), and the diagonal term taken
    one chunk at a time equal, element for element, to all chunks at
    once."""
    cj, ct = _both()
    rng = np.random.default_rng(1)
    b, s, g, r, p, n = 2, 45, 1, 8, 16, 16
    jx, tx = _pair(rng, (b, s, g, r, p), dtype)
    ja, ta = _pair(rng, (b, s, g, r), "float32", 0.1)
    ja, ta = -jnp.abs(ja), -ta.abs()
    jb, tb = _pair(rng, (b, s, g, n), dtype)
    jc, tc = _pair(rng, (b, s, g, n), dtype)
    jh0, th0 = _pair(rng, (b, g, r, p, n), "float32") if with_h0 \
        else (None, None)
    jy, jh = JM._ssd_chunked(jx, ja, jb, jc, cj, h0=jh0)
    outs = [TM._ssd_chunked(tx, ta, tb, tc, ct, h0=th0, diag_chunks=k)
            for k in (1, 2, None)]
    for y, h in outs:
        assert y.dtype == tx.dtype and y.shape == (b, s, g, r, p)
        assert_close(np.asarray(jy, np.float32), y.float(), 1e-5, "y")
        assert_close(jh, h, 1e-5, "h")
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])


def test_diag_slices_stay_under_the_byte_cap(monkeypatch):
    """The default slice of the diagonal term keeps each float32 [B,
    chunks, G, R, Q, Q] tensor within ``DIAG_BYTES``: at full width
    (32 heads, chunks of 256) batch 8 takes all 16 chunks of 4096 tokens
    at once (1 GiB) and long_500k's batch 1 128 of its 2048; a cap of one
    chunk gives the same prefill."""
    per_chunk = 4 * 32 * 256 * 256
    assert TM.DIAG_BYTES // (8 * per_chunk) == 16
    assert TM.DIAG_BYTES // per_chunk == 128
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, ct.vocab_size, (2, 70)).astype(np.int32))
    want = api.prefill(tp, ct, {"tokens": toks})
    monkeypatch.setattr(TM, "DIAG_BYTES", 1)
    got = api.prefill(tp, ct, {"tokens": toks})
    assert torch.equal(want[1], got[1])
    for k in want[0]:
        assert torch.equal(want[0][k], got[0][k]), k


def test_long_prefill_in_segments_is_the_one_shot_prefill(monkeypatch):
    """A prefill longer than ``PREFILL_SEGMENT`` runs each layer over
    segments of whole chunks, carrying the conv tail and SSM state: 70
    tokens in segments of 32 (the last of 6) give the one-shot prefill's
    logits and caches within 1e-6 (float32; the dense layers' GEMMs see
    fewer rows)."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, ct.vocab_size, (2, 70)).astype(np.int32))
    want = api.prefill(tp, ct, {"tokens": toks})
    monkeypatch.setattr(TM, "PREFILL_SEGMENT", 32)
    got = api.prefill(tp, ct, {"tokens": toks})
    assert_close(want[1], got[1], 1e-6, "logits")
    for k in want[0]:
        assert_close(want[0][k], got[0][k], 1e-6, k)


# -- the model ----------------------------------------------------------------


VARIANTS = {
    "float32": (F32_OVER, 1e-5),
    "bf16": ({}, 3e-2),
    "bf16_unrolled": (dict(scan_layers=False), 1e-2),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_decode_match(variant):
    """Prefill (45 tokens: the last of two chunks ragged) and 8 greedy
    decode steps: the logits of every call and the final conv tails and
    SSM states within the module docstring's tolerances; in float32 the
    port's ``ServingEngine.generate`` gives the reference's greedy
    tokens."""
    over, tol = VARIANTS[variant]
    cfg_j, cfg_t = _both(**over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab_size, (2, 45)
                                             ).astype(np.int32)
    out, (jc, tc), greedy = lm_run_both(cfg_j, cfg_t, jp, tp, toks)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, tol, f"{variant} call {i}")
    _caches_close(jc, tc, tol, variant)
    if variant == "float32":
        eng = ServingEngine(cfg_t, tp, ServeConfig(max_new_tokens=9),
                            device="cpu")
        assert np.array_equal(eng.generate({"tokens": toks})["tokens"],
                              greedy)


def test_int8_serving_matches_reading_conv_w_raw():
    """``quantize_for_serving`` quantizes ``conv/w`` (2-D a layer, ending
    in ``/w``), and both packages' blocks read it raw (not through
    ``W()``): the int8 model multiplies by unscaled int8 values.  The
    port reproduces that; its int8 model's logits and caches are within
    1e-5 of the reference's int8 model, unrolled over layers, over
    prefill and 8 steps."""
    cfg_j, cfg_t = _both(scan_layers=False)
    jp, jax_axes = japi.init_params(cfg_j, seed=0)
    tp, axes = api.init_params(cfg_t, seed=0, device="cpu")
    jq, jqa = japi.quantize_for_serving(cfg_j, jp, jax_axes)
    tq, tqa = api.quantize_for_serving(cfg_t, tp, axes)
    assert tqa == jqa and sorted(tq) == sorted(jq)
    assert tq["layers/conv/w"].dtype == torch.int8
    assert "layers/conv/w_scale" in tq
    for k in jq:
        if jq[k].dtype == jnp.bfloat16:
            assert_same(np.asarray(jq[k]).view(np.uint16),
                        tq[k].view(torch.int16).numpy().view(np.uint16), k)
        else:
            assert_same(jq[k], tq[k], k)
    toks = np.random.default_rng(6).integers(0, cfg_j.vocab_size, (2, 45)
                                             ).astype(np.int32)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jq, _converted(jq), toks)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, 1e-5, f"int8 call {i}")
    _caches_close(jc, tc, 1e-5, "int8")


def test_decode_writes_the_state_in_place():
    """``decode_step`` writes every layer's conv tail and SSM state into
    the cache's own tensors (the buffers a captured step reads), and
    ``grow_cache`` keeps entries that have no kv_seq axis; into kept
    buffers (``out=``) it copies them."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, ct.vocab_size, (2, 12)).astype(np.int32))
    cache, _ = api.prefill(tp, ct, {"tokens": toks})
    grown = api.grow_cache(ct, cache, 2, 12, 20)
    assert all(grown[k] is cache[k] for k in cache)
    before = {k: v.clone() for k, v in grown.items()}
    new, _ = api.decode_step(tp, ct, grown, toks[:, 0])
    for k in ("scan/conv", "scan/h"):
        assert new[k] is grown[k] and not torch.equal(new[k], before[k]), k
    kept = {k: torch.zeros_like(v) for k, v in before.items()}
    ptrs = {k: v.data_ptr() for k, v in kept.items()}
    out = api.grow_cache(ct, cache, 2, 12, 20, out=kept)
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k in kept:
        assert torch.equal(kept[k], new[k] if k != "pos" else before[k]), k
