"""The port's LM serving engine, admission gate and launcher against the
JAX package on the CPU (reduced ``llama3.2-1b``).

Tolerances: float32 runs must give the reference's greedy tokens
exactly; bfloat16 logits are held within 3e-2 of the reference's largest
logit (the reference's jitted decode keeps float32 between fused
elementwise ops that eager PyTorch rounds to bfloat16; see
tests/test_torch_lm.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.configs import get_config as jax_config
from repro.core.gate import GateConfig as JaxGateConfig
from repro.core.gate import ServeGate as JaxServeGate
from repro.models import api as japi
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.gate import GateConfig, ServeGate
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api
from repro_torch.models.param import params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServingEngine

F32 = dict(param_dtype="float32", activation_dtype="float32")


def _llama(**over):
    cj = dataclasses.replace(jax_config("llama3.2-1b", reduced=True), **over)
    ct = dataclasses.replace(get_config("llama3.2-1b", reduced=True), **over)
    jp, _ = japi.init_params(cj, seed=0)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           "cpu")
    return cj, ct, jp, tp


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_generate_tokens_match_float32(quant):
    cj, ct, jp, tp = _llama(**F32)
    toks = _tokens(0, 2, 16)
    want = JaxEngine(cj, jp, JaxServeConfig(max_new_tokens=6, quant=quant)
                     ).generate({"tokens": jnp.asarray(toks)})
    eng = ServingEngine(ct, tp, ServeConfig(max_new_tokens=6, quant=quant),
                        device="cpu")
    got = eng.generate({"tokens": toks})
    assert got["tokens"].dtype == torch.int32
    assert np.array_equal(np.asarray(want["tokens"]), got["tokens"].numpy())
    assert got["decode_tok_per_s"] > 0 and got["prefill_s"] > 0


def test_generate_bf16_logits_close():
    """bfloat16 weights: the port's engine decodes the reference's greedy
    tokens (teacher-forced) to logits within the stated tolerance."""
    cj, ct, jp, tp = _llama()
    toks = _tokens(1, 2, 16)
    jax_eng = JaxEngine(cj, jp, JaxServeConfig(max_new_tokens=5))
    want_toks = np.array(jax_eng.generate({"tokens": jnp.asarray(toks)})
                         ["tokens"])
    eng = ServingEngine(ct, tp, ServeConfig(max_new_tokens=5), device="cpu")
    jc, jl = japi.prefill(jp, cj, {"tokens": jnp.asarray(toks)})
    tc, tl = api.prefill(eng.params, ct, {"tokens": torch.from_numpy(toks)})
    jc = japi.grow_cache(cj, jc, 2, 16, 21)
    tc = api.grow_cache(ct, tc, 2, 16, 21)
    assert_close(np.asarray(jl), tl, 3e-2, "prefill")
    for i in range(4):
        step = want_toks[:, i]
        jc, jl = jax_eng._decode(jp, jc, jnp.asarray(step))
        tc, tl = api.decode_step(eng.params, ct, tc, torch.from_numpy(step))
        assert_close(np.asarray(jl, np.float32), tl, 3e-2, f"step {i}")


def _arrivals(rng, vocab, n=12):
    # arrivals must span >> N/V for admissions (the reference test's)
    return [{"stream": i % 3, "t_us": i * 400_000,
             "batch": {"tokens": rng.integers(0, vocab, (1, 8))
                       .astype(np.int32)}} for i in range(n)]


def test_serve_requests_match():
    cj, ct, jp, tp = _llama(**F32)
    arrivals = _arrivals(np.random.default_rng(2), cj.vocab_size)
    want = JaxEngine(cj, jp, JaxServeConfig(
        max_new_tokens=4, gate_backend_rate=100.0)).serve_requests(
        [dict(a, batch={"tokens": jnp.asarray(a["batch"]["tokens"])})
         for a in arrivals])
    got = ServingEngine(ct, tp, ServeConfig(
        max_new_tokens=4, gate_backend_rate=100.0), device="cpu"
    ).serve_requests(arrivals)
    assert (got["admitted"], got["denied"]) == (want["admitted"],
                                                want["denied"])
    assert got["gate_stats"] == want["gate_stats"]
    assert got["admitted"] >= 1 and got["denied"] >= 1
    for w, g in zip(want["results"], got["results"]):
        assert np.array_equal(np.asarray(w["tokens"]), g["tokens"].numpy())


def test_serve_gate_matches():
    """The numpy gate: the same arrivals and seed give the same verdicts,
    across a control-plane refresh."""
    rng = np.random.default_rng(3)
    gates = (JaxServeGate(JaxGateConfig(backend_rate=50.0), seed=4),
             ServeGate(GateConfig(backend_rate=50.0), seed=4))
    t = 0
    for i in range(300):
        t += int(rng.integers(0, 300_000))
        stream = int(rng.integers(0, 7))
        assert gates[0].offer(stream, t) == gates[1].offer(stream, t), i
        if i == 150:
            for g in gates:
                g.refresh()
    assert gates[1].admitted == gates[0].admitted > 0
    assert np.array_equal(gates[0].lut, gates[1].lut)


def test_engine_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    _, ct, _, tp = _llama()
    with pytest.raises(ValueError, match="unknown attn_backend"):
        ServingEngine(ct, tp, ServeConfig(attn_backend="pallas"),
                      device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ServingEngine(ct, tp, ServeConfig(attn_backend="cuda"),
                      device="cpu").generate({"tokens": _tokens(0, 1, 4)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(ct, tp, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(ct)


def test_launcher_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen3-4b", "--device", "cpu", "--batch",
                       "2", "--prompt-len", "8", "--new-tokens", "3",
                       "--quant", "int8", "--set", "kv_cache_dtype=int8"])
    out = capsys.readouterr().out
    assert "arch=qwen3-4b-reduced device=cpu quant=int8" in out
    assert launch_serve.apply_overrides(
        get_config("gemma-7b", reduced=True),
        {"num_layers": "3", "moe.top_k": "2", "tie_embeddings": "false"}) \
        == dataclasses.replace(
            get_config("gemma-7b", reduced=True), num_layers=3,
            tie_embeddings=False,
            moe=dataclasses.replace(get_config("gemma-7b").moe, top_k=2))


def _arch(arch, **over):
    cj = dataclasses.replace(jax_config(arch, reduced=True), **over)
    ct = dataclasses.replace(get_config(arch, reduced=True), **over)
    jp, _ = japi.init_params(cj, seed=0)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           "cpu")
    return cj, ct, jp, tp


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-4b", "qwen2.5-14b",
                                  "gemma-7b", "qwen2-moe-a2.7b"])
def test_generate_tokens_match_float32_each_config(arch):
    """Each ported config in float32: the decode step body (the one the
    card captures as a graph, run eagerly here) gives the reference's
    greedy tokens, twice on one engine (the second call writes into the
    buffers the first allocated)."""
    cj, ct, jp, tp = _arch(arch, **F32)
    toks = _tokens(4, 2, 12, vocab=cj.vocab_size)
    want = np.asarray(JaxEngine(cj, jp, JaxServeConfig(max_new_tokens=5))
                      .generate({"tokens": jnp.asarray(toks)})["tokens"])
    eng = ServingEngine(ct, tp, ServeConfig(max_new_tokens=5), device="cpu")
    for call in range(2):
        got = eng.generate({"tokens": toks})
        assert np.array_equal(want, got["tokens"].numpy()), (arch, call)
        assert got["capture_s"] == 0.0
    assert list(eng._decode_bufs) == [(2, 12, None)]


def test_serve_step_backend_knob():
    """"eager" is the CPU's default; "graph" needs CUDA; an unknown name
    raises."""
    _, ct, _, tp = _llama()
    assert ServingEngine(ct, tp, ServeConfig(),
                         device="cpu").step_backend == "eager"
    with pytest.raises(ValueError, match="CUDA"):
        ServingEngine(ct, tp, ServeConfig(step_backend="graph"),
                      device="cpu")
    with pytest.raises(ValueError, match="unknown step_backend"):
        ServingEngine(ct, tp, ServeConfig(step_backend="jit"),
                      device="cpu")


def test_launcher_prints_the_step_backend(capsys):
    """The launcher names how its decode step ran and its capture time
    (none on the CPU, which runs the step eagerly)."""
    launch_serve.main(["--arch", "llama3.2-1b", "--device", "cpu",
                       "--batch", "1", "--prompt-len", "4",
                       "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "step=eager" in out and "capture 0.000 s" in out
