"""The port's LM substrate (layers, dense GQA transformer, model API,
Registrar and weight converter) against the JAX package on the CPU.

Inputs are made with numpy from a seed; the JAX parameters go through
the converter (``params_from_numpy``), so both sides hold the same bits.

Tolerances, each relative to the reference's largest magnitude:
- float32: 1e-5 (the same float32 operations, summed in another order).
- bfloat16, the reference unrolled over layers (``scan_layers=False``,
  each op rounded to bfloat16 as PyTorch's eager ops round it): 1e-5; the
  GeGLU configs 1e-2 (XLA's bfloat16 ``tanh`` rounds one output in three
  hundred to the other neighbour).
- bfloat16 with the reference's ``lax.scan`` over layers: 3e-2.  XLA
  fuses the scanned layer body and keeps float32 between fused
  elementwise ops that eager execution rounds to bfloat16, so the two
  differ by a few bfloat16 ulps after two layers.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_same, to_numpy
from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import param as jparam
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import api
from repro_torch.models import layers as TL
from repro_torch.models.param import params_from_numpy

ARCHS = ("llama3.2-1b", "qwen3-4b", "qwen2.5-14b", "gemma-7b",
         "qwen2-moe-a2.7b")
F32_OVER = dict(param_dtype="float32", activation_dtype="float32")


def _both(arch, **over):
    return (dataclasses.replace(jax_config(arch, reduced=True), **over),
            dataclasses.replace(get_config(arch, reduced=True), **over))


def _pair(rng, shape, dtype, scale=1.0):
    j = jnp.asarray(rng.normal(0, scale, shape), getattr(jnp, dtype))
    return j, params_from_numpy({"x": np.asarray(j)}, "cpu")["x"]


def _converted(jp):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                             "cpu")


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_match(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 9, 4, 16), dtype)
    js, ts = _pair(rng, (16,), "float32")
    # float32 mean and rsqrt in another order; bfloat16 outputs may round
    # to the other neighbour
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert_close(JL.rmsnorm_1d(js, jx).astype(jnp.float32),
                 TL.rmsnorm_1d(ts, tx).float(), tol)
    assert_close(JL.rmsnorm({"n/scale": js}, "n", jx).astype(jnp.float32),
                 TL.rmsnorm({"n/scale": ts}, "n", tx).float(), tol)
    # [B,H,S,D] at positions [1,S] (prefill), [B,S,D] at [B,S]
    pos = rng.integers(0, 5000, (2, 9))
    for jxx, txx, p in ((jx.swapaxes(1, 2), tx.transpose(1, 2), pos[:1]),
                        (jx[:, :, 0], tx[:, :, 0], pos)):
        want = JL.rope(jxx, jnp.asarray(p), 500_000.0)
        got = TL.rope(txx, torch.from_numpy(p), 500_000.0)
        assert got.dtype == tx.dtype
        # float32 cos/sin of the same angles: libm against XLA's
        assert_close(want.astype(jnp.float32), got.float(), tol)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("impl", ["naive", "bands", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches(impl, dtype, window):
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng, (2, 70, 8, 16), dtype)
    jk, tk = _pair(rng, (2, 70, 2, 16), dtype)
    jv, tv = _pair(rng, (2, 70, 2, 16), dtype)
    kw = dict(impl=impl, chunk_q=32, chunk_kv=32, window=window)
    want = JL.attention(jq, jk, jv, **kw)
    got = TL.attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert_close(want.astype(jnp.float32), got.float(), tol)


def test_xblock_attention_matches():
    """Non-square layout (bands falls back to the kv-block loop)."""
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (2, 5, 4, 32), "float32")
    jk, tk = _pair(rng, (2, 70, 4, 32), "float32")
    jv, tv = _pair(rng, (2, 70, 4, 32), "float32")
    lens = np.array([70, 33], np.int32)
    for causal in (True, False):
        kw = dict(impl="bands", chunk_kv=32, causal=causal)
        assert_close(JL.attention(jq, jk, jv, kv_len=jnp.asarray(lens), **kw),
                     TL.attention(tq, tk, tv, kv_len=torch.from_numpy(lens),
                                  **kw), 1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [37, 70])
def test_chunked_attention_matches(causal, sq):
    """``impl="chunked"`` (the reference's q-chunk x kv-chunk online
    softmax, ``_chunked_attention``) against the reference in float32
    within 1e-5: causal and not, a square and a non-square layout (37
    queries over 70 keys: ragged q and kv chunks of 32), with and
    without a window, with key counts ``kv_len`` (a full row, one cut
    inside a chunk) and G = 4."""
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng, (2, sq, 8, 16), "float32")
    jk, tk = _pair(rng, (2, 70, 2, 16), "float32")
    jv, tv = _pair(rng, (2, 70, 2, 16), "float32")
    lens = np.array([70, 45], np.int32)
    for window in (None, 24):
        for kv_len in (None, lens):
            kw = dict(impl="chunked", chunk_q=32, chunk_kv=32,
                      causal=causal, window=window)
            want = JL.attention(jq, jk, jv, kv_len=None if kv_len is None
                                else jnp.asarray(kv_len), **kw)
            got = TL.attention(tq, tk, tv, kv_len=None if kv_len is None
                               else torch.from_numpy(kv_len), **kw)
            assert got.shape == (2, sq, 8, 16)
            assert_close(want, got, 1e-5, f"window {window} kv_len "
                                          f"{kv_len is not None}")


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_decode_attention_matches(dtype, window):
    """The model's own decode path (backend "ref"): p cast to the cache
    dtype before the value product, as in the reference."""
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (3, 8, 16), dtype)
    jk, tk = _pair(rng, (3, 100, 2, 16), dtype)
    jv, tv = _pair(rng, (3, 100, 2, 16), dtype)
    lens = np.array([1, 57, 100], np.int32)
    want = JL.decode_attention(jq, jk, jv, jnp.asarray(lens), window=window)
    got = TL.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                              window=window, backend="ref")
    assert got.dtype == tv.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert_close(want.astype(jnp.float32), got.float(), tol)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_round_as_jax(act):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (4096,), "bfloat16", 2.0)
    want = np.asarray(JL._act(act, jx), np.float32)
    got = TL._act(act, tx).float().numpy()
    # silu bit for bit; gelu's tanh differs from XLA's in a few outputs
    assert (want != got).mean() <= (0 if act == "silu" else 0.01)


# -- model --------------------------------------------------------------------


def _run(cfg_j, cfg_t, jp, tp, toks, steps=2):
    """Prefill, grow, then ``steps`` decode steps on the reference's
    greedy tokens: the logits of every call, from both."""
    b, s = toks.shape
    jc, jl = japi.prefill(jp, cfg_j, {"tokens": jnp.asarray(toks)})
    tc, tl = api.prefill(tp, cfg_t, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (b, cfg_t.vocab_size)
    assert tc["pos"] == int(jc["pos"]) == s
    for k in ("scan/k", "scan/v"):
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype))
    jc = japi.grow_cache(cfg_j, jc, b, s, s + steps)
    tc = api.grow_cache(cfg_t, tc, b, s, s + steps)
    out = [(np.asarray(jl, np.float32), tl)]
    for _ in range(steps):
        tok = np.argmax(out[-1][0], -1).astype(np.int32)
        jc, jl = japi.decode_step(jp, cfg_j, jc, jnp.asarray(tok))
        tc, tl = api.decode_step(tp, cfg_t, tc, torch.from_numpy(tok))
        out.append((np.asarray(jl, np.float32), tl))
    assert tc["pos"] == int(jc["pos"]) == s + steps
    return out, (jc, tc)


VARIANTS = {
    "float32": (F32_OVER, 1e-5),
    "bf16_unrolled": (dict(scan_layers=False), None),
    "bf16": ({}, 3e-2),
    "int8_kv": (dict(kv_cache_dtype="int8"), 3e-2),
}
# every config in float32 and bf16; the op-for-op bf16 check once per
# activation (SwiGLU, GeGLU) and once for the MoE blocks (the combine's
# add order, the shared expert's gate), the int8 KV cache once: the same
# code
CASES = [(a, v) for a in ARCHS for v in ("float32", "bf16")] + [
    ("llama3.2-1b", "bf16_unrolled"), ("gemma-7b", "bf16_unrolled"),
    ("qwen2-moe-a2.7b", "bf16_unrolled"), ("qwen3-4b", "int8_kv")]


@pytest.mark.parametrize("arch,variant", CASES)
def test_prefill_decode_match(arch, variant):
    over, tol = VARIANTS[variant]
    if tol is None:
        # 1e-2 (about one bfloat16 ulp of the largest value): gemma's
        # tanh (module docstring); on the MoE config one bfloat16 product
        # of the V projection lands on a rounding boundary and rounds to
        # the other neighbour (one cache element one ulp off; the logits
        # measured within 3e-7)
        tol = 1e-2 if arch in ("gemma-7b", "qwen2-moe-a2.7b") else 1e-5
    cfg_j, cfg_t = _both(arch, **over)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab_size, (2, 40)
                                             ).astype(np.int32)
    out, (jc, tc) = _run(cfg_j, cfg_t, jp, tp, toks)
    for i, (want, got) in enumerate(out):
        assert_close(want, got, tol, f"{arch} {variant} call {i}")
    if cfg_t.moe.num_experts and variant in ("bf16", "int8_kv"):
        _moe_cache_close(cfg_j, jp, toks, out, jc, tc, tol)
        return
    for k in ("scan/k", "scan/v"):
        assert_close(to_numpy(jc[k]).astype(np.float32), tc[k].float(), tol,
                     f"{arch} {variant} {k}")


def _moe_cache_close(cfg_j, jp, toks, out, jc, tc, tol):
    """The MoE caches against the scanned bfloat16 reference.  Its fused
    layer loop keeps float32 where the unrolled one rounds (module
    docstring), and a router choice between two near-equal experts can
    then fall the other way for a token: that token's K/V rows from the
    next layer on differ by O(1) between the reference's own two loops.
    The port is the unrolled reference op for op, so each cache is held
    to the unrolled reference on the same tokens everywhere, and to the
    scanned one on every row (layer, sequence, position) where the two
    reference loops agree within ``tol``."""
    b, s = toks.shape
    cfg_u = dataclasses.replace(cfg_j, scan_layers=False)
    ju, _ = japi.prefill(jp, cfg_u, {"tokens": jnp.asarray(toks)})
    ju = japi.grow_cache(cfg_u, ju, b, s, s + len(out) - 1)
    for want, _ in out[:-1]:
        tok = np.argmax(want, -1).astype(np.int32)
        ju, _ = japi.decode_step(jp, cfg_u, ju, jnp.asarray(tok))
    for k in ("scan/k", "scan/v"):
        scan = to_numpy(jc[k]).astype(np.float32)
        unrolled = to_numpy(ju[k]).astype(np.float32)
        got = tc[k].float().numpy()
        assert_close(unrolled, got, tol, f"{k} against the unrolled loop")
        agree = (np.abs(scan - unrolled) <= tol * np.abs(scan).max()
                 ).all(axis=(-1, -2))
        assert agree.mean() > 0.9, agree.mean()
        assert_close(scan[agree], got[agree], tol,
                     f"{k} where the reference's loops agree")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_position_is_a_device_scalar(arch):
    """``cache["pos"]`` is a 0-d int32 tensor on the cache's device after
    prefill and after each step (``pos + 1``, a new tensor: the caller's
    stays), equal to the reference's; each step writes its K/V row at
    that position and no other, in place."""
    cfg_j, cfg_t = _both(arch, **F32_OVER)
    jp, _ = japi.init_params(cfg_j, seed=0)
    tp = _converted(jp)
    toks = np.random.default_rng(6).integers(0, cfg_j.vocab_size, (2, 12)
                                             ).astype(np.int32)
    jc, _ = japi.prefill(jp, cfg_j, {"tokens": jnp.asarray(toks)})
    tc, _ = api.prefill(tp, cfg_t, {"tokens": torch.from_numpy(toks)})
    tc = api.grow_cache(cfg_t, tc, 2, 12, 14)
    jc = japi.grow_cache(cfg_j, jc, 2, 12, 14)
    for step in range(2):
        pos = tc["pos"]
        assert isinstance(pos, torch.Tensor) and pos.dim() == 0
        assert pos.dtype == torch.int32 and pos.device == tc["scan/k"].device
        assert int(pos) == int(jc["pos"]) == 12 + step
        k_before = tc["scan/k"].clone()
        tok = toks[:, step]
        jc, _ = japi.decode_step(jp, cfg_j, jc, jnp.asarray(tok))
        new, _ = api.decode_step(tp, cfg_t, tc, torch.from_numpy(tok))
        assert new["scan/k"] is tc["scan/k"] and int(pos) == 12 + step
        assert new["pos"] is not pos and int(new["pos"]) == 13 + step
        changed = (new["scan/k"] != k_before).flatten(3).any(-1)
        assert changed[:, :, 12 + step].all()
        changed[:, :, 12 + step] = False
        assert not changed.any()
        tc = new
    assert_close(to_numpy(jc["scan/k"]), tc["scan/k"], 1e-5, f"{arch} k")


def test_grow_cache_into_kept_buffers():
    """``grow_cache(out=)`` writes a prefill cache into the buffers of an
    earlier grown cache: the same tensors, the prefill's rows, zeros past
    them (over a longer earlier prompt's rows) and the new ``pos``."""
    cfg = get_config("llama3.2-1b", reduced=True)
    tp, _ = api.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(8)
    caches = [api.prefill(tp, cfg, {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32))})[0]
        for _ in range(2)]
    kept = api.grow_cache(cfg, caches[0], 2, 10, 16)
    kept["scan/k"][:, :, 10:] = 1
    kept["pos"].fill_(15)
    ptrs = {k: v.data_ptr() for k, v in kept.items()}
    out = api.grow_cache(cfg, caches[1], 2, 10, 16, out=kept)
    want = api.grow_cache(cfg, caches[1], 2, 10, 16)
    assert out is kept and {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k in want:
        assert torch.equal(out[k], want[k]), k
    assert int(out["pos"]) == 10


def test_quantize_for_serving_matches():
    _quantize_for_serving_matches("qwen2.5-14b")


def test_quantize_for_serving_matches_moe():
    """The MoE config: stacked expert weights [L, E, d, f] quantized one
    layer at a time (a per-layer scale, as the reference's), the router
    kept in float32; the shared expert's gate reads its raw int8 weight on
    both sides.  The int8 model's logits are held to the reference
    unrolled over layers: in its scanned loop a router choice between two
    near-equal experts falls the other way for some token
    (``_moe_cache_close``), which moves the logits by far more than a
    rounding step."""
    tq = _quantize_for_serving_matches("qwen2-moe-a2.7b", scan_layers=False)
    assert tq["layers/moe/experts/wi_gate"].dtype == torch.int8
    assert tq["layers/moe/experts/wi_gate_scale"].shape == (3,)
    assert tq["layers/moe/router/w"].dtype == torch.float32


def _quantize_for_serving_matches(arch, **over):
    cfg_j, cfg_t = _both(arch, **over)
    jp, jax_axes = japi.init_params(cfg_j, seed=0)
    tp, axes = api.init_params(cfg_t, seed=0, device="cpu")
    assert axes == jax_axes
    jq, jax_qaxes = japi.quantize_for_serving(cfg_j, jp, jax_axes)
    tq, qaxes = api.quantize_for_serving(cfg_t, tp, axes)
    assert qaxes == jax_qaxes
    assert sorted(tq) == sorted(jq)
    for k in jq:
        assert tq[k].dtype == getattr(torch, str(jq[k].dtype)), k
        if jq[k].dtype == jnp.bfloat16:
            assert_same(np.asarray(jq[k]).view(np.uint16),
                        tq[k].view(torch.int16).numpy().view(np.uint16), k)
        else:
            assert_same(jq[k], tq[k], k)
    assert any(v.dtype == torch.int8 for v in tq.values())
    meta, _ = api.quantize_for_serving(
        cfg_t, *api.init_params(cfg_t, abstract=True))
    assert all(v.is_meta for v in meta.values())
    assert {k: (v.shape, v.dtype) for k, v in meta.items()} == \
        {k: (v.shape, v.dtype) for k, v in tq.items()}
    # the int8 model serves logits close to the reference's int8 model
    toks = np.random.default_rng(6).integers(0, 512, (2, 16)
                                             ).astype(np.int32)
    out, _ = _run(cfg_j, cfg_t, jq, _converted(jq), toks, steps=1)
    for want, got in out:
        assert_close(want, got, 3e-2)
    return tq


@pytest.mark.parametrize("arch", ARCHS)
def test_registrar_draws_match(arch, monkeypatch):
    """The port's Registrar makes the reference's numpy draws: equal as
    float64 before the dtype cast, and bit for bit after the bfloat16
    cast."""
    cfg_j, cfg_t = _both(arch)
    jp, _ = japi.init_params(cfg_j, seed=3)
    tp, _ = api.init_params(cfg_t, seed=3, device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype)), k
        assert_same(np.asarray(jp[k]).view(np.uint16)
                    if jp[k].dtype == jnp.bfloat16 else jp[k],
                    tp[k].view(torch.int16).numpy().view(np.uint16)
                    if tp[k].dtype == torch.bfloat16 else tp[k], k)
    # before the cast: the reference Registrar's float64 draws, captured
    monkeypatch.setattr(jparam, "jnp", SimpleNamespace(
        asarray=lambda a, dtype=None: a, bfloat16=jnp.bfloat16))
    reg_j = jparam.Registrar(seed=3)
    japi._family(cfg_j).init_params(reg_j, cfg_j)
    reg_t = api.Registrar(seed=3, dtype=torch.float64)
    api._family(cfg_t).init_params(reg_t, cfg_t)
    for k, v in reg_j.params.items():
        assert v.dtype == np.float64
        got = reg_t.params[k].numpy()
        # a parameter registered as float32 (norm scales; the MoE router)
        # is that cast of the float64 draw
        assert np.array_equal(v.astype(got.dtype), got), k


def test_converter_defaults_to_cuda(monkeypatch):
    """``params_from_numpy`` without a device puts the tensors on
    ``cuda``, as every entry point of the port, and raises on a host
    without it (never a silent CPU copy)."""
    from repro_torch.models import param as tparam

    arrays = {"w": np.ones((2, 3), np.float32)}
    if torch.cuda.is_available():
        assert params_from_numpy(arrays)["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_numpy(arrays)
    monkeypatch.setattr(tparam, "resolve_device",
                        lambda device: torch.device("cpu")
                        if device is None else torch.device(device))
    assert params_from_numpy(arrays)["w"].device.type == "cpu"


def test_converter_is_bit_exact_and_copies():
    jp, _ = japi.init_params(jax_config("llama3.2-1b", reduced=True), seed=1)
    tp = _converted(jp)
    for k, v in jp.items():
        a = np.asarray(v)
        b = tp[k]
        assert tuple(b.shape) == a.shape
        if a.dtype == jnp.bfloat16:
            assert np.array_equal(a.view(np.uint16),
                                  b.view(torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(a, b.numpy())
    tp["embed/table"].zero_()                 # the port's copy, not JAX's
    assert float(jnp.abs(jp["embed/table"]).max()) > 0


def test_specs_and_param_counts_match():
    for arch in ARCHS:
        for reduced in (True, False):
            cj = jax_config(arch, reduced=reduced)
            ct = get_config(arch, reduced=reduced)
            assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
            assert api.analytic_param_count(ct) == \
                japi.analytic_param_count(cj)
            assert ct.param_count() == cj.param_count()
            js = japi.cache_specs(cj, 4, 100)
            ts = api.cache_specs(ct, 4, 100)
            assert sorted(js) == sorted(ts)
            for k in js:
                assert js[k][0] == ts[k][0] and js[k][2] == ts[k][2], k
                assert str(ts[k][1]) == f"torch.{js[k][1].__name__}", k
    # the transformers here, MLA's deepseek-v2 (tests/test_torch_mla.py),
    # the ssm and hybrid families (tests/test_torch_ssm.py,
    # tests/test_torch_hybrid.py), the encdec and vlm families
    # (tests/test_torch_encdec.py, tests/test_torch_vlm.py)
    assert set(list_archs()) == set(ARCHS) | {
        "deepseek-v2-236b", "mamba2-370m", "recurrentgemma-9b",
        "seamless-m4t-medium", "llama-3.2-vision-11b"}


def test_unported_families_raise():
    """Every family of the reference is served: MLA attention (here on a
    GQA config switched to it, over MoE blocks) initializes and caches
    its latent ``ckv`` and rope key ``kpe``, each with a ``kv_seq`` axis;
    an unknown family name is refused."""
    mla = dataclasses.replace(get_config("llama3.2-1b", reduced=True),
                              attention="mla", kv_lora_rank=32,
                              moe=MoEConfig(num_experts=4, top_k=2,
                                            expert_d_ff=32))
    params, _ = api.init_params(mla, device="cpu")
    assert params["layers/attn/wdkv/w"].shape == (2, 64, 32)
    assert "layers/attn/wk/w" not in params
    specs = api.cache_specs(mla, 2, 16)
    assert sorted(specs) == ["pos", "scan/ckv", "scan/kpe"]
    assert specs["scan/ckv"][0] == (2, 2, 16, 32)
    assert all(specs[k][2][2] == "kv_seq" for k in ("scan/ckv", "scan/kpe"))
    assert sorted(api._FAMILIES) == ["encdec", "hybrid", "ssm",
                                     "transformer", "vlm"]
    with pytest.raises(ValueError, match="unknown model family"):
        api.init_params(ModelConfig(name="m", family="rnn"), device="cpu")


# -- MoE ----------------------------------------------------------------------


def _moe_pair(moe, d=64, seed=0):
    """The reference's init_moe params (float32) and the port's copy."""
    reg = jparam.Registrar(seed=seed, dtype=jnp.float32)
    JL.init_moe(reg, "moe", d, moe)
    return reg.params, _converted(reg.params)


MOE_SMALL = MoEConfig(num_experts=8, top_k=2, expert_d_ff=48,
                      num_shared_experts=2, shared_d_ff=96,
                      shared_gated=True)
# qwen2-moe's routing (60 experts, top 4) at a narrow width
MOE_WIDE = MoEConfig(num_experts=60, top_k=4, expert_d_ff=24,
                     num_shared_experts=4, shared_d_ff=96, shared_gated=True)


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("case", ["prefill", "decode_cap1"])
def test_moe_ffn_matches(case, chunks):
    """``moe_ffn`` against the reference's, float32 (1e-5 of the largest
    output: the same products in another summation order), the aux loss
    within 1e-6 relative.  "prefill": [2, 24] tokens on 8 experts, top 2
    (cap 15); "decode_cap1": one token each of a
    batch of 8 on 60 experts, top 4 (cap = max(1, int(1.25 * 8 * 4 /
    60)) = 1, so an expert keeps only its first routed pair and the
    others are dropped).  The reference dispatches in ``dispatch_chunks``
    1 and 2 chunks; the port ignores the field (one dispatch on one
    card) and matches both."""
    moe = MOE_SMALL if case == "prefill" else MOE_WIDE
    moe = dataclasses.replace(moe, dispatch_chunks=chunks)
    shape = (2, 24, 64) if case == "prefill" else (8, 1, 64)
    jp, tp = _moe_pair(moe)
    jx, tx = _pair(np.random.default_rng(9), shape, "float32")
    jy, jaux = JL.moe_ffn(jp, "moe", jx, moe, "silu")
    ty, taux = TL.moe_ffn(tp, "moe", tx, moe, "silu")
    assert ty.shape == shape and ty.dtype == torch.float32
    assert_close(jy, ty, 1e-5, case)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    # pairs were dropped: some expert was routed more than its capacity
    logits = np.asarray(jx).reshape(-1, 64) @ np.asarray(jp["moe/router/w"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :moe.top_k]
    counts = np.bincount(top.reshape(-1), minlength=moe.num_experts)
    t = shape[0] * shape[1]
    cap = max(1, int(moe.capacity_factor * t * moe.top_k / moe.num_experts))
    assert cap == (1 if case == "decode_cap1" else 15)
    assert counts.max() > cap, counts


def test_moe_ffn_bf16_matches():
    """bfloat16 activations and weights: the combine adds each token's k
    outputs in the reference's scatter order and the shared gate's
    sigmoid rounds op for op, so the port is within 1e-5 of the
    reference's largest output."""
    jp32, _ = _moe_pair(MOE_WIDE)
    jp = {k: v if k.endswith("router/w") else v.astype(jnp.bfloat16)
          for k, v in jp32.items()}
    tp = _converted(jp)
    jx, tx = _pair(np.random.default_rng(10), (8, 1, 64), "bfloat16")
    jy, _ = JL.moe_ffn(jp, "moe", jx, MOE_WIDE, "silu")
    ty, _ = TL.moe_ffn(tp, "moe", tx, MOE_WIDE, "silu")
    assert ty.dtype == torch.bfloat16
    assert_close(jy.astype(jnp.float32), ty.float(), 1e-5)


def test_moe_top_k_breaks_ties_to_the_lower_index():
    """``lax.top_k``'s tie order: equal probabilities go to the lower
    expert first."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    val, idx = TL._top_k(probs, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    j = JL.jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.array_equal(np.asarray(j[1]), idx.numpy())


@pytest.mark.parametrize("variant", ["float32", "bf16_unrolled"])
def test_first_dense_layers_match(variant):
    """A MoE config whose first layer is a dense block (``layer0/``, as
    deepseek-v2's): the same params, cache entries and logits as the
    reference through prefill and two decode steps (float32 and the
    unrolled bfloat16 reference: 1e-5)."""
    over = dict(F32_OVER if variant == "float32" else
                dict(scan_layers=False))
    cfg_j, cfg_t = _both("qwen2-moe-a2.7b", **over)
    moe = dataclasses.replace(cfg_j.moe, first_dense_layers=1,
                              first_dense_d_ff=80)
    cfg_j = dataclasses.replace(cfg_j, moe=moe)
    cfg_t = dataclasses.replace(cfg_t, moe=moe)
    jp, jax_axes = japi.init_params(cfg_j, seed=0)
    tp, axes = api.init_params(cfg_t, seed=0, device="cpu")
    assert sorted(tp) == sorted(jp) and axes == jax_axes
    assert tp["layer0/mlp/wi_gate"].shape == (64, 80)
    assert tp["layers/moe/experts/wo"].shape[0] == cfg_t.num_layers - 1
    tp = _converted(jp)
    toks = np.random.default_rng(7).integers(0, cfg_j.vocab_size, (2, 20)
                                             ).astype(np.int32)
    out, (jc, tc) = _run(cfg_j, cfg_t, jp, tp, toks)
    assert sorted(tc) == sorted(jc)
    assert "layer0/k" in tc and tc["scan/k"].shape[0] == 2
    for i, (want, got) in enumerate(out):
        assert_close(want, got, 1e-5, f"call {i}")
    for k in ("layer0/k", "layer0/v", "scan/k"):
        assert_close(to_numpy(jc[k]).astype(np.float32), tc[k].float(),
                     1e-5, k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_registrar_chunked_threaded_draw_is_the_one_shot_draw(
        dtype, monkeypatch):
    """Chunks of 1000 values (each stacked expert weight [3, 8, 64, 96]
    draws 6144-value layer slices row block by row block) filled in
    ``api.init_params``'s thread pool give the one-shot draw of every
    parameter, bit for bit, cast as the one-shot float64 draw casts."""
    from repro_torch.models import param as tparam

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", reduced=True),
                              param_dtype=str(dtype).split(".")[1])
    monkeypatch.setattr(tparam, "_CHUNK_ELEMS", 1000)
    got, _ = api.init_params(cfg, seed=4, device="cpu")
    one = tparam.Registrar(abstract=True, seed=4)
    spec = {}
    orig = tparam.Registrar.param

    def record(self, path, shape, axes, init="normal", scale=None,
               dtype=None):
        spec[path] = (shape, init, scale)
        return orig(self, path, shape, axes, init=init, scale=scale,
                    dtype=dtype)

    monkeypatch.setattr(tparam.Registrar, "param", record)
    api._family(cfg).init_params(one, cfg)
    for path, (shape, init, scale) in spec.items():
        want = torch.from_numpy(tparam.draw(path, shape, init, scale, 4))
        if got[path].dtype != torch.float32:
            want = want.to(got[path].dtype)
        assert torch.equal(got[path], want.to(got[path].dtype)), path
    assert set(got) == set(spec)
