"""The port's MLA attention (``models/transformer.py``: multi-head latent
attention, ``deepseek-v2-236b``) against the JAX package on the CPU, on
the config's ``reduced()`` (3 layers: a dense ``layer0/`` and two MoE
layers of 8 experts, top 2, 2 shared; 4 heads, q-LoRA 32, latent 24,
q and k 16 + 8 wide against v 16).

Tolerances, each relative to the reference's largest magnitude:
- float32: 1e-5 (the same float32 operations, summed in another order;
  measured 1.6e-6).
- bfloat16 against the reference unrolled over layers
  (``scan_layers=False``): 3e-2.  Every op rounds as the reference's, but
  a GEMM's summation order now and then rounds a bfloat16 output to the
  other neighbour (as in the encdec and vlm tests): measured 1.5e-7 on
  the logits with the caches equal at one 40-token prompt, 6.1e-3 at
  another (``test_int8_kv_cache_is_the_reference_s``).
- bfloat16 against the scanned reference: 3e-2, the transformer family's
  (tests/test_torch_lm.py: XLA keeps float32 inside the fused layer
  body).  Its router can then send a near-tied token the other way from
  the unrolled loop's, which moves that token's latent rows in the next
  layer by far more than a rounding step: the caches are held to the
  unrolled loop everywhere and to the scanned one where the reference's
  two loops agree (``_mla_cache_close``, as ``_moe_cache_close``).
- int8 weights: 3e-2 against the unrolled reference, the transformer
  family's (tests/test_torch_lm.py).  The dequantized weights are the
  reference's bits, but their products land on bfloat16 rounding
  boundaries more often than drawn weights' do, and a GEMM's summation
  order then rounds a q element to the other neighbour (the first
  differs in q-LoRA's ``cq``); measured 9.8e-3 of the largest logit at a
  24-token prompt.  Such a flip can also tip a router's near tie (a
  40-token prompt's prefill sends one token to another expert in the
  second layer, which moves its logits by 0.9 of the largest): the test
  runs a 12-token prompt and two steps, as the transformer family's int8
  test runs 16 tokens and one step.

The absorbed decode and the decompressed prefill compute the same
attention by different algebra; each is held to the reference's own.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_same, lm_run_both, to_numpy
from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import param as jparam
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models import layers as TL
from repro_torch.models.param import params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServingEngine

ARCH = "deepseek-v2-236b"
F32_OVER = dict(param_dtype="float32", activation_dtype="float32")
CACHE_KEYS = ("layer0/ckv", "layer0/kpe", "scan/ckv", "scan/kpe")


def _both(reduced=True, **over):
    return (dataclasses.replace(jax_config(ARCH, reduced=reduced), **over),
            dataclasses.replace(get_config(ARCH, reduced=reduced), **over))


def _converted(jp):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                             "cpu")


def _tokens(seed, s, b=2):
    return np.random.default_rng(seed).integers(0, 512, (b, s)
                                                ).astype(np.int32)


def _same_bits(jp, tp):
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype)), k
        if jp[k].dtype == jnp.bfloat16:
            assert_same(np.asarray(jp[k]).view(np.uint16),
                        tp[k].view(torch.int16).numpy().view(np.uint16), k)
        else:
            assert_same(jp[k], tp[k], k)


# -- config, counts, specs, draws ----------------------------------------------


def test_config_counts_and_specs_match():
    """The full and reduced configs are the reference's field for field;
    the parameter counts and cache specs (the latent ``ckv`` and rope key
    ``kpe``, each with a ``kv_seq`` axis) equal the reference's; the full
    model's abstract parameters (meta tensors) are 236 B, of which every
    one but the embedding table and the norm scales is a matmul
    parameter that ``analytic_param_count`` counts."""
    for reduced in (True, False):
        cj, ct = _both(reduced)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
        assert api.analytic_param_count(ct) == japi.analytic_param_count(cj)
        assert api.analytic_param_count(ct, active_only=True) == \
            japi.analytic_param_count(cj, active_only=True)
        assert ct.param_count() == cj.param_count()
        js, ts = japi.cache_specs(cj, 4, 100), api.cache_specs(ct, 4, 100)
        assert sorted(js) == sorted(ts) == sorted(CACHE_KEYS + ("pos",))
        for k in js:
            assert js[k][0] == ts[k][0] and js[k][2] == ts[k][2], k
            assert str(ts[k][1]) == f"torch.{js[k][1].__name__}", k
        assert ts["scan/ckv"][2] == ("layers", "batch", "kv_seq", "kv_lora")
    full = get_config(ARCH)
    meta, axes = api.init_params(full, abstract=True)
    assert all(v.is_meta for v in meta.values())
    total = sum(v.numel() for v in meta.values())
    side = sum(v.numel() for k, v in meta.items()
               if k == "embed/table" or k.endswith("/scale"))
    assert total - side == api.analytic_param_count(full)
    assert 235e9 < total < 237e9
    assert meta["layers/attn/wuq/w"].shape == (59, 1536, 128, 192)
    assert axes["layers/attn/wuk/w"] == ("layers", "kv_lora", "heads",
                                         "qk_dim")


@pytest.mark.parametrize("q_lora", [32, 0])
def test_registrar_draws_match(q_lora, monkeypatch):
    """The port's Registrar makes the reference's draws for every MLA
    weight, with a q-LoRA (wdq, q_norm, wuq) and without (wq): bit for
    bit after the bfloat16 cast, equal as float64 before it, under the
    reference's keys and axes."""
    cj, ct = _both(q_lora_rank=q_lora)
    jp, jax_axes = japi.init_params(cj, seed=3)
    tp, axes = api.init_params(ct, seed=3, device="cpu")
    assert axes == jax_axes
    _same_bits(jp, tp)
    if q_lora:
        assert tp["layers/attn/wuq/w"].shape == (2, 32, 4, 24)
        assert "layers/attn/wq/w" not in tp
    else:
        assert tp["layer0/attn/wq/w"].shape == (64, 4, 24)
        assert "layers/attn/wdq/w" not in tp
    monkeypatch.setattr(jparam, "jnp", SimpleNamespace(
        asarray=lambda a, dtype=None: a, bfloat16=jnp.bfloat16))
    reg_j = jparam.Registrar(seed=3)
    japi._family(cj).init_params(reg_j, cj)
    reg_t = api.Registrar(seed=3, dtype=torch.float64)
    api._family(ct).init_params(reg_t, ct)
    assert list(reg_t.params) == list(reg_j.params)     # the same order
    for k, v in reg_j.params.items():
        got = reg_t.params[k].numpy()
        assert np.array_equal(v.astype(got.dtype), got), k


# -- prefill and decode ---------------------------------------------------------


def _mla_cache_close(cfg_j, jp, toks, out, jc, tc, tol):
    """The latent caches against the scanned bfloat16 reference (module
    docstring): held to the unrolled reference on the same tokens
    everywhere, and to the scanned one on every (layer, sequence,
    position) row where the reference's two loops agree within ``tol``."""
    b, s = toks.shape
    cfg_u = dataclasses.replace(cfg_j, scan_layers=False)
    ju, _ = japi.prefill(jp, cfg_u, {"tokens": jnp.asarray(toks)})
    ju = japi.grow_cache(cfg_u, ju, b, s, s + len(out) - 1)
    for want, _ in out[:-1]:
        ju, _ = japi.decode_step(jp, cfg_u, ju, jnp.asarray(
            np.argmax(want, -1).astype(np.int32)))
    for k in CACHE_KEYS:
        scan = to_numpy(jc[k]).astype(np.float32)
        unrolled = to_numpy(ju[k]).astype(np.float32)
        got = tc[k].float().numpy()
        assert_close(unrolled, got, tol, f"{k} against the unrolled loop")
        agree = (np.abs(scan - unrolled) <= tol * np.abs(scan).max()
                 ).all(axis=-1)
        assert agree.mean() > 0.9, (k, agree.mean())
        assert_close(scan[agree], got[agree], tol,
                     f"{k} where the reference's loops agree")


VARIANTS = {
    "float32": (F32_OVER, 1e-5),
    "float32_no_q_lora": (dict(F32_OVER, q_lora_rank=0), 1e-5),
    "bf16_unrolled": (dict(scan_layers=False), 3e-2),
    "bf16": ({}, 3e-2),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_decode_match(variant):
    """A 40-token prefill and three greedy decode steps: the logits of
    every call, the latent and rope-key caches (prefill rows and the
    three written by the absorbed decode), ``pos`` a 0-d int32 device
    tensor throughout, all within the module docstring's tolerances."""
    over, tol = VARIANTS[variant]
    cfg_j, cfg_t = _both(**over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks = _tokens(5, 40)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jp, tp, toks, steps=3)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, tol, f"{variant} call {i}")
    assert tc["scan/ckv"].shape == (2, 2, 43, 24)
    assert tc["layer0/kpe"].shape == (2, 43, 8)
    if variant == "bf16":
        _mla_cache_close(cfg_j, jp, toks, out, jc, tc, tol)
        return
    for k in CACHE_KEYS:
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
        assert_close(to_numpy(jc[k]).astype(np.float32), tc[k].float(), tol,
                     f"{variant} {k}")


def test_decode_writes_one_latent_row_in_place():
    """A decode step at position p writes row p of every layer's ``ckv``
    and ``kpe`` in place and no other row (a one-lane ``index_copy_``);
    ``pos`` advances as a new tensor."""
    _, ct = _both(**F32_OVER)
    tp, _ = api.init_params(ct, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(4, 12))
    cache, _ = api.prefill(tp, ct, {"tokens": toks})
    cache = api.grow_cache(ct, cache, 2, 12, 14)
    before = {k: v.clone() for k, v in cache.items()}
    new, _ = api.decode_step(tp, ct, cache, toks[:, 0])
    for k in CACHE_KEYS:
        assert new[k] is cache[k], k
        changed = (new[k] != before[k]).any(-1)
        assert changed[..., 12].all(), k
        changed[..., 12] = False
        assert not changed.any(), k
    assert int(new["pos"]) == 13 and int(cache["pos"]) == 12


def test_int8_weights_match():
    """``quantize_for_serving`` on MLA: the 3-D ``wuq`` / ``wuk`` / ``wuv``
    (and their stacked 4-D forms, a scale a layer) and every 2-D matmul
    weight become the reference's int8 bits and scales; the q and latent
    norm scales stay float32.  The int8 model's logits and caches through
    a prefill and two steps within 3e-2 of the unrolled reference's
    (module docstring)."""
    cfg_j, cfg_t = _both(scan_layers=False)
    jp, jax_axes = japi.init_params(cfg_j, seed=0)
    tp, axes = api.init_params(cfg_t, seed=0, device="cpu")
    jq, jqa = japi.quantize_for_serving(cfg_j, jp, jax_axes)
    tq, tqa = api.quantize_for_serving(cfg_t, tp, axes)
    assert tqa == jqa
    _same_bits(jq, tq)
    for k in ("layers/attn/wuq/w", "layers/attn/wuk/w", "layer0/attn/wuv/w",
              "layers/attn/wdkv/w", "layer0/attn/wo/w"):
        assert tq[k].dtype == torch.int8 and f"{k}_scale" in tq, k
    assert tq["layers/attn/wuk/w_scale"].shape == (2,)
    assert tq["layers/attn/kv_norm/scale"].dtype == torch.float32
    assert "layers/attn/q_norm/scale_scale" not in tq
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jq, _converted(jq),
                                   _tokens(6, 12), steps=2)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, 3e-2, f"int8 call {i}")
    for k in CACHE_KEYS:
        assert_close(to_numpy(jc[k]).astype(np.float32), tc[k].float(),
                     3e-2, f"int8 {k}")


def test_int8_kv_cache_is_the_reference_s():
    """``kv_cache_dtype="int8"`` with MLA, as the reference does it: the
    cache specs say int8, but prefill emits the latent in the activation
    dtype, ``grow_cache`` keeps it, and decode writes into that cache
    (the logits within 3e-2, as the unrolled bfloat16 run's); a decode
    step into a
    spec-shaped int8 cache is refused by both (the reference's
    ``dynamic_update_slice`` of a bfloat16 row into int8 raises)."""
    over = dict(kv_cache_dtype="int8", scan_layers=False)
    cfg_j, cfg_t = _both(**over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks = _tokens(7, 40)
    out, (jc, tc), _ = lm_run_both(cfg_j, cfg_t, jp, tp, toks, steps=3)
    for want, got in out:
        assert_close(want, got, 3e-2)
    for k in CACHE_KEYS:
        assert jc[k].dtype == jnp.bfloat16 and tc[k].dtype == torch.bfloat16
        assert api.cache_specs(cfg_t, 2, 43)[k][1] == torch.int8
        assert japi.cache_specs(cfg_j, 2, 43)[k][1] == jnp.int8
    spec_j = {k: jnp.zeros(shp, dt) for k, (shp, dt, _)
              in japi.cache_specs(cfg_j, 2, 43).items()}
    spec_t = {k: torch.zeros(shp, dtype=dt) for k, (shp, dt, _)
              in api.cache_specs(cfg_t, 2, 43).items()}
    with pytest.raises(TypeError, match="same dtype"):
        japi.decode_step(jp, cfg_j, spec_j, jnp.asarray(toks[:, 0]))
    with pytest.raises(RuntimeError, match="same dtype"):
        api.decode_step(tp, cfg_t, spec_t, torch.from_numpy(toks[:, 0]))


# -- attention at Dk != Dv --------------------------------------------------------


@pytest.mark.parametrize("impl", ["bands", "chunked", "naive"])
def test_attention_impls_take_dk_other_than_dv(impl):
    """``layers.attention`` with q and k 24 wide (MLA's 16 + 8) against v
    16 wide, as MLA's prefill calls it: each impl against the
    reference's, float32 within 1e-5, in the square causal layout (with
    a window too), and 5 queries over 70 keys with key counts (bands:
    the kv-block loop); then the whole reduced model's prefill and two
    decode steps on the chunked and naive impls (``bands``, the
    default, in ``test_prefill_decode_match``)."""
    rng = np.random.default_rng(12)

    def pair(shape):
        j = jnp.asarray(rng.normal(0, 1, shape), jnp.float32)
        return j, torch.from_numpy(np.array(j))

    (jq, tq), (jk, tk), (jv, tv) = (pair((2, 70, 4, 24)), pair((2, 70, 4, 24)),
                                    pair((2, 70, 4, 16)))
    for window in (None, 24):
        kw = dict(impl=impl, chunk_q=32, chunk_kv=32, window=window)
        got = TL.attention(tq, tk, tv, **kw)
        assert got.shape == (2, 70, 4, 16)
        assert_close(JL.attention(jq, jk, jv, **kw), got, 1e-5,
                     f"{impl} window {window}")
    lens = np.array([70, 33], np.int32)
    kw = dict(impl=impl, chunk_q=32, chunk_kv=32, causal=True)
    assert_close(JL.attention(jq[:, :5], jk, jv, kv_len=jnp.asarray(lens),
                              **kw),
                 TL.attention(tq[:, :5], tk, tv,
                              kv_len=torch.from_numpy(lens), **kw), 1e-5,
                 f"{impl} 5 over 70")
    if impl == "bands":
        return
    cfg_j, cfg_t = _both(attention_impl=impl, scan_layers=False, **F32_OVER)
    jp, _ = japi.init_params(cfg_j, seed=1)
    out, _, _ = lm_run_both(cfg_j, cfg_t, jp, _converted(jp), _tokens(8, 40),
                            steps=2)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, 1e-5, f"{impl} model call {i}")


def test_band_attention_batch_slices_are_the_whole_batch(monkeypatch):
    """Past ``BAND_BYTES`` the band attention runs a slice of sequences at
    a time (deepseek-v2's 128 heads at batch 8 x 4096): the same values
    as the whole batch at once, MLA's Dk != Dv included."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.normal(0, 1, (5, 70, 4, 24)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (5, 70, 4, 24)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (5, 70, 4, 16)).astype(np.float32))
    whole = TL.attention(q, k, v, impl="bands", chunk_q=32)
    # one sequence's first band: 3 blocks x 4 heads x 32 x 32 floats
    monkeypatch.setattr(TL, "BAND_BYTES", 2 * 3 * 4 * 32 * 32 * 4)
    sliced = TL.attention(q, k, v, impl="bands", chunk_q=32)
    assert torch.equal(whole, sliced)


# -- cache growth and serving -------------------------------------------------------


def test_grow_cache_matches_and_fills_kept_buffers():
    """``grow_cache`` pads ``ckv`` / ``kpe`` along their kv_seq axis as
    the reference does (the dense layer's unstacked entries and the
    stacked ones); ``out=`` writes a second prefill into the first's
    grown buffers, keeping their addresses."""
    cfg_j, cfg_t = _both(scan_layers=False, **F32_OVER)
    jp, _ = japi.init_params(cfg_j, seed=2)
    tp = _converted(jp)
    toks = _tokens(9, 10)
    jc, _ = japi.prefill(jp, cfg_j, {"tokens": jnp.asarray(toks)})
    tc, _ = api.prefill(tp, cfg_t, {"tokens": torch.from_numpy(toks)})
    jg = japi.grow_cache(cfg_j, jc, 2, 10, 16)
    tg = api.grow_cache(cfg_t, tc, 2, 10, 16)
    for k in CACHE_KEYS:
        assert tuple(tg[k].shape) == jg[k].shape, k
        assert_close(to_numpy(jg[k]), tg[k], 1e-5, k)
        assert not tg[k][..., 10:, :].any(), k
    ptrs = {k: v.data_ptr() for k, v in tg.items()}
    tc2, _ = api.prefill(tp, cfg_t, {"tokens": torch.from_numpy(
        _tokens(10, 10))})
    out = api.grow_cache(cfg_t, tc2, 2, 10, 16, out=tg)
    want = api.grow_cache(cfg_t, tc2, 2, 10, 16)
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k in want:
        assert torch.equal(out[k], want[k]), k


def test_generate_matches_the_reference_greedy_loop():
    """``ServingEngine.generate`` on the CPU (float32, eager step) gives
    the reference engine's greedy tokens: a 20-token prompt, 6 new
    tokens."""
    cfg_j, cfg_t = _both(**F32_OVER)
    jp, _ = japi.init_params(cfg_j, seed=0)
    toks = _tokens(11, 20)
    want = JaxEngine(cfg_j, jp, JaxServeConfig(max_new_tokens=6)).generate(
        {"tokens": jnp.asarray(toks)})
    got = ServingEngine(cfg_t, _converted(jp), ServeConfig(max_new_tokens=6),
                        device="cpu").generate({"tokens": toks})
    assert np.array_equal(np.asarray(want["tokens"]), got["tokens"].numpy())


def test_mla_decode_is_the_decompressed_attention():
    """The absorbed decode (W_UK folded into q, the scores over the
    latent) and the decompressed prefill attention compute the same
    thing by different algebra: in float32 the logits after a 16-token
    prefill and 4 teacher-forced steps equal those of one prefill of all
    20 tokens within 1e-5, and so do the caches.  At batch 1 and a
    capacity factor of e / k no MoE pair is dropped at prefill or at
    decode (each drops differently: its capacity comes from its own
    token count), so every layer computes the same function on both
    paths."""
    _, ct = _both(**F32_OVER)
    m = ct.moe
    ct = dataclasses.replace(ct, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    tp, _ = api.init_params(ct, seed=5, device="cpu")
    toks = torch.from_numpy(_tokens(12, 20, b=1))
    cache, logits = api.prefill(tp, ct, {"tokens": toks[:, :16]})
    cache = api.grow_cache(ct, cache, 1, 16, 20)
    for i in range(16, 20):
        cache, logits = api.decode_step(tp, ct, cache, toks[:, i])
    whole, want = api.prefill(tp, ct, {"tokens": toks})
    # the 4th step's input is token 19: its logits are the last
    # position's of the 20-token prefill
    assert_close(want, logits, 1e-5)
    for k in CACHE_KEYS:
        assert_close(whole[k], cache[k], 1e-5, k)


def test_launcher_serves_mla_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek-v2-236b``
    serves the reduced config on the CPU; ``--set num_layers=2`` cuts
    its depth to the dense layer and one MoE layer, as the card's run
    cuts the full width's."""
    from repro_torch.launch import serve as launch_serve

    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3",
                       "--set", "num_layers=2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced device=cpu quant=none" in out
    assert "sample tokens:" in out
