"""The port's vision LM (``models/vlm.py``, ``llama-3.2-vision-11b``)
against the JAX package on the CPU, on the config's ``reduced()``
overridden to 10 layers: two superblocks of [4 self + 1 gated cross]
(4 query heads over 2 KV heads, 16 image tokens).

The gates ``gate_attn`` / ``gate_mlp`` start at 0, where ``tanh(0) = 0``
makes every cross layer the identity: the image would reach no logit
and a broken cross path would pass.  So the model tests run with the
gates set to 0.5 (and, in float32, at 0 too).

Tolerances, each relative to the reference's largest magnitude:
- float32: 1e-5 (the same float32 operations, summed in another order).
- bfloat16 against the reference unrolled over layers
  (``scan_layers=False``): 3e-2.  Measured: the bfloat16 GEMMs of the two
  packages sum their float32 products in another order and round a few
  outputs in ten thousand to the other bfloat16 neighbour
  (tests/test_torch_encdec.py); over 10 layers, 8 steps and 23- to
  64-token prompts the unrolled reference's logits measured 0 to 1.4e-2
  from the port's (gates at 0 and 0.5; 1.6e-2 at the 40-token prompt
  below).
- bfloat16 against the scanned reference: 5e-2.  XLA also keeps float32
  inside its fused layer body, and 10 layers carry it further than the
  transformer tests' 2 (3e-2 there): measured 1.7e-2 to 2.6e-2 over the
  prompts above, 2.8e-2 at the 40-token prompt below.
- int8 weights: 3e-2 against the unrolled reference (the same flips;
  measured 8.0e-3).

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
from repro.models import param as jparam
from repro.models import vlm as JV
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api
from repro_torch.models import vlm as TV
from repro_torch.models.param import params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServingEngine

ARCH = "llama-3.2-vision-11b"
F32_OVER = dict(param_dtype="float32", activation_dtype="float32")
LAYERS = 10     # two superblocks


def _both(reduced=True, **over):
    if reduced:
        over = {"num_layers": LAYERS, **over}
    return (dataclasses.replace(jax_config(ARCH, reduced=reduced), **over),
            dataclasses.replace(get_config(ARCH, reduced=reduced), **over))


def _gated(jp, gate):
    """The reference's params with both gates of every cross layer at
    ``gate``."""
    return {k: (jnp.full_like(v, gate) if k.endswith(("gate_attn",
                                                       "gate_mlp")) else v)
            for k, v in jp.items()}


def _converted(jp):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                             "cpu")


def _inputs(seed, b, s, cfg, s_img=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    img = rng.normal(0, 1, (b, s_img or cfg.num_image_tokens, cfg.d_model)
                     ).astype(np.float32)
    return toks, img


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
    """Full and reduced (the registered 5 layers and the 10 here): the same
    config fields, parameter counts and cache specs; the image entries
    have ``num_image_tokens`` rows whatever ``smax``."""
    for reduced, over in ((True, {}), (True, {"num_layers": 10}),
                          (False, {})):
        cj = dataclasses.replace(jax_config(ARCH, reduced=reduced), **over)
        ct = dataclasses.replace(get_config(ARCH, reduced=reduced), **over)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
        assert api.analytic_param_count(ct) == japi.analytic_param_count(cj)
        assert ct.param_count() == cj.param_count()
        js, ts = japi.cache_specs(cj, 4, 100), api.cache_specs(ct, 4, 100)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert js[k][0] == ts[k][0] and js[k][2] == ts[k][2], k
            assert str(ts[k][1]) == f"torch.{jnp.dtype(js[k][1]).name}", k
    full = get_config(ARCH)
    specs = api.cache_specs(full, 8, 4128)
    assert specs["sb/self3/k"][0] == (8, 8, 4128, 8, 128)
    assert specs["sb/cross/xk"][0] == (8, 8, 4096, 8, 128)
    assert api.cache_specs(full, 8, 100, src_len=7) == \
        api.cache_specs(full, 8, 100)
    # 9.77 B parameters, the embedding table and the head included
    meta, _ = api.init_params(full, abstract=True)
    assert 9.7e9 < sum(v.numel() for v in meta.values()) < 9.8e9


def test_registrar_draws_match(monkeypatch):
    """The port's Registrar makes the reference's draws (the gates float32
    zeros): bit for bit after the bfloat16 cast, equal as float64 before
    it."""
    cj, ct = _both()
    jp, jax_axes = japi.init_params(cj, seed=3)
    tp, axes = api.init_params(ct, seed=3, device="cpu")
    assert sorted(jp) == sorted(tp) and axes == jax_axes
    assert tp["sb/self3/attn/wk/w"].shape == (2, 64, 2, 16)
    for g in ("sb/cross/gate_attn", "sb/cross/gate_mlp"):
        assert tp[g].dtype == torch.float32 and tp[g].shape == (2,)
        assert not tp[g].any()
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype)), k
        assert_same(np.asarray(jp[k]).view(np.uint16)
                    if jp[k].dtype == jnp.bfloat16 else jp[k],
                    tp[k].view(torch.int16).numpy().view(np.uint16)
                    if tp[k].dtype == torch.bfloat16 else tp[k], k)
    monkeypatch.setattr(jparam, "jnp", SimpleNamespace(
        asarray=lambda a, dtype=None: a, bfloat16=jnp.bfloat16))
    reg_j = jparam.Registrar(seed=3)
    JV.init_params(reg_j, cj)
    reg_t = api.Registrar(seed=3, dtype=torch.float64)
    TV.init_params(reg_t, ct)
    for k, v in reg_j.params.items():
        got = reg_t.params[k].numpy()
        assert np.array_equal(v.astype(got.dtype), got), k


# -- the layers ---------------------------------------------------------------


@pytest.mark.parametrize("gate", [0.0, 0.5])
def test_cross_layer_matches(gate):
    """The gated cross layer from a prompt (against the image) and from
    one decode query (against its cached K/V), float32 within 1e-5; at
    gate 0 it is the identity, and the prefill's image K/V are the
    reference's."""
    cj, ct = _both(**F32_OVER)
    jp, _ = japi.init_params(cj, seed=2)
    jp = _gated(jp, gate)
    tp = _converted(jp)
    pj = {k[len("sb/cross/"):]: v[1] for k, v in jp.items()
          if k.startswith("sb/cross/")}
    pt = {k[len("sb/cross/"):]: v[1] for k, v in tp.items()
          if k.startswith("sb/cross/")}
    toks, img = _inputs(3, 2, 1, cj)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 11, 64)).astype(np.float32)
    jy, jc = JV._cross_layer(pj, cj, jnp.asarray(x),
                             img_embeds=jnp.asarray(img), mode="prefill")
    ty, tc = TV._cross_layer(pt, ct, torch.from_numpy(x),
                             img_embeds=torch.from_numpy(img))
    assert_close(jy, ty, 1e-5, "prefill")
    for k in ("xk", "xv"):
        assert_close(jc[k], tc[k], 1e-5, k)
    jyd, _ = JV._cross_layer(pj, cj, jnp.asarray(x[:, 0]),
                             xkv=(jc["xk"], jc["xv"]), mode="decode")
    tyd, _ = TV._cross_layer(pt, ct, torch.from_numpy(x[:, 0]),
                             xkv=(tc["xk"], tc["xv"]))
    assert_close(jyd, tyd, 1e-5, "decode")
    if gate == 0.0:
        assert torch.equal(ty, torch.from_numpy(x))
    else:
        assert not torch.allclose(ty, torch.from_numpy(x))


# -- the model ----------------------------------------------------------------


VARIANTS = {"float32": (F32_OVER, 1e-5),
            "bf16_unrolled": (dict(scan_layers=False), 3e-2),
            "bf16": ({}, 5e-2)}
CASES = [("float32", 0.0), ("float32", 0.5), ("bf16_unrolled", 0.5),
         ("bf16", 0.5)]


@pytest.mark.parametrize("variant,gate", CASES)
def test_prefill_decode_match(variant, gate):
    """Prefill (a 40-token prompt, 16 image tokens) and 8 greedy decode
    steps: the logits of every call and the final caches (four self K/V
    entries grown to 48 rows, the image K/V of 16) within the module
    docstring's tolerances, ``pos`` a 0-d device tensor throughout."""
    over, tol = VARIANTS[variant]
    cfg_j, cfg_t = _both(**over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    jp = _gated(jp, gate)
    tp = _converted(jp)
    toks, img = _inputs(1, 2, 40, cfg_j)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jp, tp, toks,
                                   extra={"image_embeds": img})
    assert tc["sb/self0/k"].shape == (2, 2, 48, 2, 16)
    assert tc["sb/cross/xk"].shape == (2, 2, 16, 2, 16)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, tol, f"{variant} gate {gate} call {i}")
    _caches_close(jc, tc, tol, f"{variant} gate {gate}")


def test_gates_let_the_image_reach_the_logits():
    """float32: at gates 0 every cross layer is the identity, so the
    logits do not depend on the image; at gates 0.5 another image moves
    them."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks, img = _inputs(5, 2, 12, ct)
    img2 = _inputs(6, 2, 12, ct)[1]

    def logits(params, image):
        return api.prefill(params, ct, {
            "tokens": torch.from_numpy(toks),
            "image_embeds": torch.from_numpy(image)})[1]

    assert torch.equal(logits(tp, img), logits(tp, img2))
    tp5 = {k: (torch.full_like(v, 0.5) if k.endswith(("gate_attn",
                                                       "gate_mlp")) else v)
           for k, v in tp.items()}
    assert not torch.allclose(logits(tp5, img), logits(tp5, img2))


def test_decode_writes_the_self_rows_and_reads_the_image_cache():
    """A decode step at position p writes row p of every self layer's K/V
    in place and no other row; the image K/V are not written."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks, img = _inputs(4, 2, 12, ct)
    cache, _ = api.prefill(tp, ct, {"tokens": torch.from_numpy(toks),
                                    "image_embeds": torch.from_numpy(img)})
    cache = api.grow_cache(ct, cache, 2, 12, 15)
    before = {k: v.clone() for k, v in cache.items()}
    new, _ = api.decode_step(tp, ct, cache, torch.from_numpy(toks[:, 0]))
    for j in range(4):
        k = f"sb/self{j}/k"
        assert new[k] is cache[k]
        changed = (new[k] != before[k]).flatten(3).any(-1)
        assert changed[:, :, 12].all(), k
        changed[:, :, 12] = False
        assert not changed.any(), k
    for k in ("sb/cross/xk", "sb/cross/xv"):
        assert torch.equal(new[k], before[k]), k
    assert int(new["pos"]) == 13 and int(cache["pos"]) == 12


def test_grow_cache_keeps_image_entries_and_writes_kept_buffers():
    """``grow_cache`` pads the self K/V and keeps the image K/V as the
    prefill made them; with ``out=`` a second prefill lands in the same
    tensors (zeros past its rows, its image K/V, its ``pos``)."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    caches = [api.prefill(tp, ct, {
        "tokens": torch.from_numpy(toks),
        "image_embeds": torch.from_numpy(img)})[0]
        for toks, img in (_inputs(7, 2, 10, ct), _inputs(8, 2, 10, ct))]
    kept = api.grow_cache(ct, caches[0], 2, 10, 16)
    assert kept["sb/cross/xk"] is caches[0]["sb/cross/xk"]
    assert kept["sb/self2/v"].shape == (2, 2, 16, 2, 16)
    kept["sb/self1/k"][:, :, 10:] = 1
    ptrs = {k: v.data_ptr() for k, v in kept.items()}
    out = api.grow_cache(ct, caches[1], 2, 10, 16, out=kept)
    want = api.grow_cache(ct, caches[1], 2, 10, 16)
    assert out is kept and {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k in want:
        assert torch.equal(out[k], want[k]), k


def test_int8_serving_matches():
    """``quantize_for_serving`` keeps the gates float32 and quantizes the
    self and cross projections; the int8 model (gates 0.5) stays within
    3e-2 (module docstring) of the reference's, unrolled over layers."""
    cfg_j, cfg_t = _both(scan_layers=False)
    jp, jax_axes = japi.init_params(cfg_j, seed=0)
    jp = _gated(jp, 0.5)
    jq, jqa = japi.quantize_for_serving(cfg_j, jp, jax_axes)
    tq, tqa = api.quantize_for_serving(cfg_t, _converted(jp), jax_axes)
    assert tqa == jqa and sorted(tq) == sorted(jq)
    for k in ("sb/self0/attn/wq/w", "sb/cross/xattn/wv/w", "head/w"):
        assert tq[k].dtype == torch.int8 and f"{k}_scale" in tq, k
    assert tq["sb/cross/gate_attn"].dtype == torch.float32
    for k in jq:
        if jq[k].dtype == jnp.bfloat16:
            assert_same(np.asarray(jq[k]).view(np.uint16),
                        tq[k].view(torch.int16).numpy().view(np.uint16), k)
        else:
            assert_same(jq[k], tq[k], k)
    toks, img = _inputs(1, 2, 40, cfg_j)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jq, _converted(jq), toks,
                                   extra={"image_embeds": img})
    for i, (want, got) in enumerate(out):
        assert_close(want, got, 3e-2, f"int8 call {i}")
    _caches_close(jc, tc, 3e-2, "int8")


# -- the serving engine and the launcher --------------------------------------


@pytest.mark.parametrize("gate", [0.0, 0.5])
def test_generate_matches_the_reference_engine(gate):
    """float32: ``ServingEngine.generate`` with ``image_embeds`` gives the
    reference engine's greedy tokens, twice on one engine."""
    cj, ct = _both(**F32_OVER)
    jp, _ = japi.init_params(cj, seed=0)
    jp = _gated(jp, gate)
    tp = _converted(jp)
    toks, img = _inputs(8, 2, 12, cj)
    want = np.asarray(JaxEngine(cj, jp, JaxServeConfig(max_new_tokens=6))
                      .generate({"tokens": jnp.asarray(toks),
                                 "image_embeds": jnp.asarray(img)})
                      ["tokens"])
    eng = ServingEngine(ct, tp, ServeConfig(max_new_tokens=6), device="cpu")
    for call in range(2):
        got = eng.generate({"tokens": toks, "image_embeds": img})
        assert np.array_equal(want, got["tokens"].numpy()), call
    assert list(eng._decode_bufs) == [(2, 12, 16)]


def test_two_image_lengths_get_their_own_buffers():
    """Requests with 16 and with 9 image tokens, in turns (gates 0.5): one
    set of decode buffers each, with image K/V of that length, and each
    request's tokens those of a fresh engine."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    tp = {k: (torch.full_like(v, 0.5) if k.endswith(("gate_attn",
                                                      "gate_mlp")) else v)
          for k, v in tp.items()}
    eng = ServingEngine(ct, tp, ServeConfig(max_new_tokens=5), device="cpu")
    for seed, s_img in ((9, 16), (10, 9), (11, 16)):
        toks, img = _inputs(seed, 2, 12, ct, s_img)
        batch = {"tokens": toks, "image_embeds": img}
        got = eng.generate(batch)["tokens"]
        fresh = ServingEngine(ct, tp, ServeConfig(max_new_tokens=5),
                              device="cpu").generate(batch)["tokens"]
        assert torch.equal(got, fresh)
    assert sorted(eng._decode_bufs) == [(2, 12, 9), (2, 12, 16)]
    for key, bufs in eng._decode_bufs.items():
        assert bufs["cache"]["sb/cross/xk"].shape[2] == key[2]


def test_launcher_runs_on_cpu():
    """``python -m repro_torch.launch.serve --arch llama-3.2-vision-11b``
    on the CPU: the reduced model with ``num_image_tokens`` image
    embeddings."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch",
                           "2", "--prompt-len", "12", "--new-tokens", "4"])
    text = buf.getvalue()
    assert "arch=llama-3.2-vision-11b-reduced device=cpu" in text
    assert "sample tokens:" in text
