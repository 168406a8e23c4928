"""The port's encoder-decoder family (``models/encdec.py``,
``seamless-m4t-medium``) against the JAX package on the CPU, on the
config's ``reduced()`` (2 encoder + 2 decoder layers, d_model 64, 4
heads of 16).  The source length differs from the prompt's throughout,
so a cross cache grown to the self cache's length would show.

Tolerances, each relative to the reference's largest magnitude:
- float32: 1e-5 (the same float32 operations, summed in another order).
- bfloat16, against the reference unrolled over layers
  (``scan_layers=False``) and against the scanned one: 3e-2.  Measured:
  the bfloat16 GEMMs of the two packages sum their float32 products in
  another order and round about 0.03% of their outputs to the other
  bfloat16 neighbour (the encoder's K projection 0.034%, its MLP
  0.034%; with the same inputs the attention is bit for bit the
  reference's).  Whether a flip happens depends on the data: over 8
  steps at 23- to 64-token prompts the unrolled reference's logits
  measured 0 to 1.1e-2 (1.4e-2 at the 40-token prompt below) from the
  port's, the scanned reference's (XLA also keeps float32 inside its
  fused layer body) 1.4e-2 to 1.7e-2.
- int8 weights: 3e-2 against the unrolled reference (the same flips;
  measured 1.5e-7 at the prompt below).

The reference's decode step is jitted here, as its serving engine jits
it; the unrolled reference runs op by op.
"""

import dataclasses
import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_same, lm_run_both, to_numpy
from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import encdec as JE
from repro.models import param as jparam
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api
from repro_torch.models import encdec as TE
from repro_torch.models.param import params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServingEngine

ARCH = "seamless-m4t-medium"
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


def _inputs(seed, b, s, s_src, cfg):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    src = rng.normal(0, 1, (b, s_src, cfg.d_model)).astype(np.float32)
    return toks, src


def _layer(params, i, prefix):
    return {k[len(prefix):]: v[i] for k, v in params.items()
            if k.startswith(prefix)}


def _caches_close(jc, tc, tol, where):
    assert sorted(jc) == sorted(tc)
    for k in jc:
        if k == "pos":
            continue
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
        assert tc[k].shape == jc[k].shape, k
        assert_close(to_numpy(jc[k]).astype(np.float32), tc[k].float(), tol,
                     f"{where} {k}")


# -- config, counts, specs, draws ---------------------------------------------


def test_config_counts_and_specs_match():
    """Full and reduced: the same config fields, parameter counts, and
    cache specs at a source length other than the prompt's (and at the
    default, ``smax``); the cross entries keep their shape whatever
    ``smax``."""
    for reduced in (True, False):
        cj, ct = _both(reduced)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
        assert api.analytic_param_count(ct) == japi.analytic_param_count(cj)
        assert ct.param_count() == cj.param_count()
        for src_len in (None, 37):
            js = japi.cache_specs(cj, 4, 100, src_len=src_len)
            ts = api.cache_specs(ct, 4, 100, src_len=src_len)
            assert sorted(js) == sorted(ts)
            for k in js:
                assert js[k][0] == ts[k][0] and js[k][2] == ts[k][2], k
                assert str(ts[k][1]) == \
                    f"torch.{jnp.dtype(js[k][1]).name}", k
    full = get_config(ARCH)
    specs = api.cache_specs(full, 8, 4128, src_len=2048)
    assert specs["dec/k"][0] == (12, 8, 4128, 16, 64)
    assert specs["dec/xk"][0] == (12, 8, 2048, 16, 64)
    assert api.cache_specs(full, 8, 4128)["dec/xk"][0][2] == 4128
    # 0.98 B parameters, the embedding table and the head included
    meta, _ = api.init_params(full, abstract=True)
    assert 0.97e9 < sum(v.numel() for v in meta.values()) < 0.99e9


def test_registrar_draws_match(monkeypatch):
    """The port's Registrar makes the reference's draws: bit for bit after
    the bfloat16 cast, equal as float64 before it."""
    cj, ct = _both()
    jp, jax_axes = japi.init_params(cj, seed=3)
    tp, axes = api.init_params(ct, seed=3, device="cpu")
    assert sorted(jp) == sorted(tp) and axes == jax_axes
    assert tp["dec/xattn/wq/w"].shape == (2, 64, 4, 16)
    assert tp["enc/mlp/wi_gate"].shape == (2, 64, 128)
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype)), k
        assert_same(np.asarray(jp[k]).view(np.uint16)
                    if jp[k].dtype == jnp.bfloat16 else jp[k],
                    tp[k].view(torch.int16).numpy().view(np.uint16)
                    if tp[k].dtype == torch.bfloat16 else tp[k], k)
    monkeypatch.setattr(jparam, "jnp", SimpleNamespace(
        asarray=lambda a, dtype=None: a, bfloat16=jnp.bfloat16))
    reg_j = jparam.Registrar(seed=3)
    JE.init_params(reg_j, cj)
    reg_t = api.Registrar(seed=3, dtype=torch.float64)
    TE.init_params(reg_t, ct)
    for k, v in reg_j.params.items():
        got = reg_t.params[k].numpy()
        assert np.array_equal(v.astype(got.dtype), got), k


# -- encoder and cross attention ----------------------------------------------


@pytest.mark.parametrize("impl", ["bands", "chunked"])
def test_encode_matches(impl):
    """The encoder (non-causal, rope on the encoder positions) over a
    37-frame source, float32: within 1e-5; with the chunked attention
    too (37 frames in chunks of 32: a ragged last chunk)."""
    cj, ct = _both(attention_impl=impl, **F32_OVER)
    jp, _ = japi.init_params(cj, seed=1)
    tp = _converted(jp)
    _, src = _inputs(2, 2, 1, 37, cj)
    want = JE.encode(jp, cj, jnp.asarray(src))
    got = TE.encode(tp, ct, torch.from_numpy(src))
    assert got.shape == (2, 37, 64) and got.dtype == torch.float32
    assert_close(want, got, 1e-5, impl)


def test_cross_kv_and_cross_attend_match():
    """``cross_kv`` on an encoder output and ``cross_attend`` from a
    prompt (non-causal attention over every key) and from one decode
    query (the decode attention over every key, lengths made on the
    device), float32: within 1e-5."""
    cj, ct = _both(**F32_OVER)
    jp, _ = japi.init_params(cj, seed=2)
    tp = _converted(jp)
    pj, pt = _layer(jp, 1, "dec/"), _layer(tp, 1, "dec/")
    rng = np.random.default_rng(3)
    jctx, tctx = _pair(rng, (2, 29, 64), "float32")
    jk, jv = JE.cross_kv(pj, cj, jctx)
    tk, tv = TE.cross_kv(pt, ct, tctx)
    assert tk.shape == (2, 29, 4, 16)
    assert_close(jk, tk, 1e-5, "xk")
    assert_close(jv, tv, 1e-5, "xv")
    for shape in ((2, 11, 64), (2, 64)):
        jx, tx = _pair(rng, shape, "float32")
        want = JE.cross_attend(pj, cj, jx, jk, jv)
        got = TE.cross_attend(pt, ct, tx, tk, tv)
        assert got.shape == shape
        assert_close(want, got, 1e-5, f"cross_attend {shape}")


# -- the model ----------------------------------------------------------------


VARIANTS = {"float32": (F32_OVER, 1e-5),
            "bf16_unrolled": (dict(scan_layers=False), 3e-2),
            "bf16": ({}, 3e-2)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_decode_match(variant):
    """Prefill (a 40-token prompt against a 23-frame source) and 8 greedy
    decode steps: the logits of every call and the final caches (self
    K/V grown to 48 rows, cross K/V of 23) within the module docstring's
    tolerances, ``pos`` a 0-d device tensor throughout."""
    over, tol = VARIANTS[variant]
    cfg_j, cfg_t = _both(**over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks, src = _inputs(1, 2, 40, 23, cfg_j)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jp, tp, toks,
                                   extra={"src_embeds": src})
    assert tc["dec/k"].shape == (2, 2, 48, 4, 16)
    assert tc["dec/xk"].shape == (2, 2, 23, 4, 16)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, tol, f"{variant} call {i}")
    _caches_close(jc, tc, tol, variant)


def test_decode_writes_the_self_row_and_reads_the_cross_cache():
    """A decode step at position p writes row p of every layer's self K/V
    in place and no other row; the cross K/V are not written."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks, src = _inputs(4, 2, 12, 7, ct)
    cache, _ = api.prefill(tp, ct, {"tokens": torch.from_numpy(toks),
                                    "src_embeds": torch.from_numpy(src)})
    cache = api.grow_cache(ct, cache, 2, 12, 15, src_len=7)
    before = {k: v.clone() for k, v in cache.items()}
    new, _ = api.decode_step(tp, ct, cache, torch.from_numpy(toks[:, 0]))
    assert new["dec/k"] is cache["dec/k"]
    changed = (new["dec/k"] != before["dec/k"]).flatten(3).any(-1)
    assert changed[:, :, 12].all()
    changed[:, :, 12] = False
    assert not changed.any()
    for k in ("dec/xk", "dec/xv"):
        assert torch.equal(new[k], before[k]), k
    assert int(new["pos"]) == 13 and int(cache["pos"]) == 12


def test_grow_cache_keeps_cross_entries_and_writes_kept_buffers():
    """``grow_cache(src_len=)`` pads the self K/V to the new length and
    keeps the cross K/V as the prefill made them (the reference's rule);
    with ``out=`` it writes a second prefill into the same tensors: the
    prefill's rows, zeros past them, its cross K/V and its ``pos``."""
    cj, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    jp, _ = japi.init_params(cj, seed=0)
    caches = []
    for seed in (5, 6):
        toks, src = _inputs(seed, 2, 10, 9, ct)
        caches.append(api.prefill(tp, ct, {
            "tokens": torch.from_numpy(toks),
            "src_embeds": torch.from_numpy(src)})[0])
    jcache, _ = japi.prefill(jp, cj, {"tokens": jnp.asarray(toks),
                                      "src_embeds": jnp.asarray(src)})
    jgrown = japi.grow_cache(cj, jcache, 2, 10, 16, src_len=9)
    kept = api.grow_cache(ct, caches[0], 2, 10, 16, src_len=9)
    assert kept["dec/xk"] is caches[0]["dec/xk"]
    assert kept["dec/k"].shape == (2, 2, 16, 4, 16)
    assert {k: tuple(v.shape) for k, v in kept.items()} == \
        {k: tuple(v.shape) for k, v in jgrown.items()}
    kept["dec/k"][:, :, 10:] = 1
    kept["pos"].fill_(15)
    ptrs = {k: v.data_ptr() for k, v in kept.items()}
    out = api.grow_cache(ct, caches[1], 2, 10, 16, src_len=9, out=kept)
    want = api.grow_cache(ct, caches[1], 2, 10, 16, src_len=9)
    assert out is kept and {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k in want:
        assert torch.equal(out[k], want[k]), k
    assert int(out["pos"]) == 10
    _caches_close(jgrown, want, 1e-5, "grown")


def test_int8_serving_matches():
    """``quantize_for_serving`` on the encdec params (every projection of
    the encoder, the decoder's self and cross attention, the MLPs, the
    table and head) equals the reference's, and the int8 model's logits
    and caches stay within 3e-2 (module docstring) of the reference's,
    unrolled over layers."""
    cfg_j, cfg_t = _both(scan_layers=False)
    jp, jax_axes = japi.init_params(cfg_j, seed=0)
    tp, axes = api.init_params(cfg_t, seed=0, device="cpu")
    jq, jqa = japi.quantize_for_serving(cfg_j, jp, jax_axes)
    tq, tqa = api.quantize_for_serving(cfg_t, tp, axes)
    assert tqa == jqa and sorted(tq) == sorted(jq)
    for k in ("enc/attn/wk/w", "dec/xattn/wq/w", "dec/attn/wo/w", "head/w"):
        assert tq[k].dtype == torch.int8 and f"{k}_scale" in tq, k
    for k in jq:
        if jq[k].dtype == jnp.bfloat16:
            assert_same(np.asarray(jq[k]).view(np.uint16),
                        tq[k].view(torch.int16).numpy().view(np.uint16), k)
        else:
            assert_same(jq[k], tq[k], k)
    toks, src = _inputs(7, 2, 40, 23, cfg_j)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jq, _converted(jq), toks,
                                   extra={"src_embeds": src})
    for i, (want, got) in enumerate(out):
        assert_close(want, got, 3e-2, f"int8 call {i}")
    _caches_close(jc, tc, 3e-2, "int8")


# -- the serving engine and the launcher --------------------------------------


def test_generate_matches_the_reference_engine():
    """float32: ``ServingEngine.generate`` with ``src_embeds`` gives the
    reference engine's greedy tokens, twice on one engine (the second
    call writes into the first's buffers)."""
    cj, ct = _both(**F32_OVER)
    jp, _ = japi.init_params(cj, seed=0)
    tp = _converted(jp)
    toks, src = _inputs(8, 2, 12, 19, cj)
    want = np.asarray(JaxEngine(cj, jp, JaxServeConfig(max_new_tokens=6))
                      .generate({"tokens": jnp.asarray(toks),
                                 "src_embeds": jnp.asarray(src)})["tokens"])
    eng = ServingEngine(ct, tp, ServeConfig(max_new_tokens=6), device="cpu")
    for call in range(2):
        got = eng.generate({"tokens": toks, "src_embeds": src})
        assert np.array_equal(want, got["tokens"].numpy()), call
    assert list(eng._decode_bufs) == [(2, 12, 19)]
    assert eng._decode_bufs[(2, 12, 19)]["cache"]["dec/xk"].shape[2] == 19


def test_two_source_lengths_get_their_own_buffers():
    """Requests of one prompt length with two source lengths (11 and 17
    frames), in turns: one set of decode buffers each, with cross K/V of
    that length, and each request's tokens those of a fresh engine."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    eng = ServingEngine(ct, tp, ServeConfig(max_new_tokens=5), device="cpu")
    reqs = [_inputs(seed, 2, 12, s_src, ct)
            for seed, s_src in ((9, 11), (10, 17), (11, 11))]
    for toks, src in reqs:
        got = eng.generate({"tokens": toks, "src_embeds": src})["tokens"]
        fresh = ServingEngine(ct, tp, ServeConfig(max_new_tokens=5),
                              device="cpu").generate(
            {"tokens": toks, "src_embeds": src})["tokens"]
        assert torch.equal(got, fresh)
    assert sorted(eng._decode_bufs) == [(2, 12, 11), (2, 12, 17)]
    for key, bufs in eng._decode_bufs.items():
        assert bufs["cache"]["dec/xk"].shape[2] == key[2]


def test_launcher_runs_on_cpu():
    """``python -m repro_torch.launch.serve --arch seamless-m4t-medium``
    on the CPU: the reduced model with ``src_embeds`` of the prompt's
    length, as the reference's launcher makes them."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch",
                           "2", "--prompt-len", "12", "--new-tokens", "4"])
    text = buf.getvalue()
    assert "arch=seamless-m4t-medium-reduced device=cpu" in text
    assert "sample tokens:" in text
