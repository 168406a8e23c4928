"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*).

Each parity test feeds the same numpy inputs, made from a seed, to a
reference (JAX) function and to its port, and compares the results leaf
by leaf.  Integer outputs (the FENIX data plane) must be equal
(``assert_same``); floating-point outputs (the LM substrate) are held to
a stated tolerance (``assert_close``).
"""

import functools

import numpy as np
import pytest


def to_numpy(x):
    """A JAX array, torch tensor, number or nested dict/list -> numpy
    (int64 for integers, so uint32 and int64-held uint32 compare)."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_numpy(v) for v in x]
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        return a.astype(np.int64)
    return a


def assert_same(ref, port, where=""):
    """Exact leaf-by-leaf equality of two nested results."""
    r, p = to_numpy(ref), to_numpy(port)
    if isinstance(r, dict):
        assert sorted(r) == sorted(p), (where, sorted(r), sorted(p))
        for k in r:
            assert_same(r[k], p[k], f"{where}.{k}")
        return
    if isinstance(r, list):
        assert len(r) == len(p), where
        for i, (a, b) in enumerate(zip(r, p)):
            assert_same(a, b, f"{where}[{i}]")
        return
    assert r.shape == p.shape, (where, r.shape, p.shape)
    assert np.array_equal(r, p), (where, np.argwhere(r != p)[:5])


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the Hopper kernels have no CPU mode."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the hand-written "
                    "Hopper kernels have no CPU mode")
    return torch.device("cuda")


def assert_close(ref, port, tol, where=""):
    """Floating-point results within ``tol`` of the reference's largest
    magnitude: max |ref - port| <= tol * max |ref| (leaf by leaf; NaNs
    must sit at the same places).  Each caller states why its ``tol``."""
    r = np.asarray(to_numpy(ref), np.float64)
    p = np.asarray(to_numpy(port), np.float64)
    assert r.shape == p.shape, (where, r.shape, p.shape)
    nan = np.isnan(r)
    assert np.array_equal(nan, np.isnan(p)), (where, "NaN positions differ")
    if nan.all():
        return
    err = np.abs(r - p)[~nan].max()
    scale = max(np.abs(r[~nan]).max(), 1e-30)
    assert err <= tol * scale, (where, f"max|diff| {err:.3g} > {tol} x "
                                       f"max|ref| {scale:.3g}")


# -- the pipes and farm drivers (tests/test_torch_pipes.py, _farm.py) -------

def vmap_fallback(mp):
    """Send the reference's pipes and farm drivers down their vmap
    fallback for as long as the pytest ``MonkeyPatch`` ``mp`` holds: the
    mesh functions (``pipe_mesh``, ``farm_mesh``) return None.  With
    enough JAX devices the reference builds a mesh, and its
    ``shard_map(..., check_rep=False)`` raises under the installed JAX;
    the vmap is the reference's semantics, and the port (pipes and
    engines as tensor dimensions) is held to it.  No file of the
    reference changes."""
    import repro.core.fenix as jfenix
    import repro.core.model_engine.engine_farm as jfarm

    mp.setattr(jfenix, "pipe_mesh", lambda num_pipes: None)
    mp.setattr(jfarm, "farm_mesh", lambda num_pipes, num_engines: None)


def tiny_int8_pair(flows, n_calib=128):
    """int8_cnn_tiny, JAX init + quantize (untrained) on ``flows``'
    windows: (the reference's EngineModel, the port's with the same
    weights on the CPU)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.fenix_models import fenix_cnn_tiny
    from repro.core.model_engine.inference import EngineModel as JModel
    from repro.data.synthetic_traffic import windows_from_flows
    from repro.models import traffic as jtraffic
    from repro.quant.quantize import quantize_traffic
    from repro_torch.configs.fenix_models import (
        fenix_cnn_tiny as t_fenix_cnn_tiny)
    from repro_torch.core.model_engine.inference import EngineModel
    from repro_torch.core.model_engine.serving import qparams_from_numpy

    cfg = fenix_cnn_tiny()
    x, _, _ = windows_from_flows(flows)
    qp = quantize_traffic(jtraffic.init(cfg, seed=0), cfg,
                          jnp.asarray(x[:n_calib]))
    return JModel(cfg, qp), EngineModel(
        t_fenix_cnn_tiny(),
        qparams_from_numpy(jax.tree.map(np.asarray, qp), "cpu"))


def skewed(stream, engine_cfg, num_pipes, keep=6):
    """``stream`` with all but every ``keep``-th packet of the pipes other
    than pipe 0 dropped: the pipes' streams end far apart, so the uniform
    steps freeze pipes (and a pipe may have no full batch at all)."""
    from repro_torch.core.data_engine.state import (hash_five_tuple,
                                                    pipe_of_hash)

    import torch

    h = hash_five_tuple(*(torch.from_numpy(np.asarray(stream[k]).astype(
        np.int64)) for k in ("src_ip", "dst_ip", "src_port", "dst_port",
                             "proto"))).numpy()
    pipe = pipe_of_hash(h, engine_cfg, num_pipes)
    rank = np.cumsum(pipe > 0)
    sel = (pipe == 0) | (rank % keep == 0)
    return {k: np.asarray(v)[sel] for k, v in stream.items()}


def assert_pipes_run_same(ref, port, where=""):
    """Stats and the whole stacked carry of a pipes / farm run (and the
    farm's engine queues) equal, leaf by leaf."""
    assert port.stats == ref.stats, (where, ref.stats, port.stats)
    names = ("pstate", "pqueues", "pdl") + (("eq",) if port._use_farm
                                           else ())
    for name in names:
        assert_same(dict(getattr(ref, name)), dict(getattr(port, name)),
                    f"{where} {name}")


def stacked_packets(rng, num_pipes, n):
    """Random packet batches of ``num_pipes`` pipes (the reference's
    ``make_packets``, one a pipe), numpy [P, n] each, and the same as the
    port's tensors (the five-tuple in int64): (numpy, torch)."""
    import torch

    from repro.core.data_engine.state import make_packets

    per = [make_packets(rng, n) for _ in range(num_pipes)]
    packets = {k: np.stack([b[k] for b in per]) for k in per[0]}
    return packets, {k: torch.from_numpy(v.astype(
        np.int32 if k in ("ts_us", "pkt_len") else np.int64))
        for k, v in packets.items()}


# -- LM families: prefill and greedy decode on both packages -----------------

@functools.cache
def _jit_decode():
    """The reference's ``decode_step`` under ``jax.jit`` (the config
    static), made once per process."""
    import jax

    from repro.models import api as japi

    return jax.jit(japi.decode_step, static_argnums=1)


def lm_run_both(cfg_j, cfg_t, jp, tp, toks, steps=8, extra=None):
    """Prefill, grow, then ``steps`` greedy decode steps on the
    reference's tokens, on both packages: (the logits of every call as
    (reference, port) pairs, the final caches, the reference's greedy
    tokens [B, steps + 1]).  ``extra``: the batch's other inputs as numpy
    arrays (``src_embeds`` of the encdec family, ``image_embeds`` of the
    vlm); the cache grows at the source length of ``src_embeds`` (else
    the prompt's), as the reference's serving engine grows it.  The
    port's ``pos`` is checked at every step: a 0-d int32 tensor on the
    cache's device, a new tensor each step, equal to the reference's.  A
    scanned reference's decode step is jitted, as its serving engine
    jits it (its ``lax.scan`` over layers would otherwise compile again
    at every call)."""
    import jax.numpy as jnp
    import torch

    from repro.models import api as japi
    from repro_torch.models import api

    b, s = toks.shape
    extra = extra or {}
    src_len = extra.get("src_embeds", toks).shape[1]
    jc, jl = japi.prefill(jp, cfg_j, {"tokens": jnp.asarray(toks), **{
        k: jnp.asarray(v) for k, v in extra.items()}})
    tc, tl = api.prefill(tp, cfg_t, {"tokens": torch.from_numpy(toks), **{
        k: torch.from_numpy(v) for k, v in extra.items()}})
    assert tl.dtype == torch.float32 and tl.shape == (b, cfg_t.vocab_size)
    jc = japi.grow_cache(cfg_j, jc, b, s, s + steps, src_len=src_len)
    tc = api.grow_cache(cfg_t, tc, b, s, s + steps, src_len=src_len)
    assert sorted(tc) == sorted(jc)
    out = [(np.asarray(jl, np.float32), tl)]
    decode = _jit_decode() if cfg_j.scan_layers else japi.decode_step
    for i in range(steps):
        pos = tc["pos"]
        assert isinstance(pos, torch.Tensor) and pos.dim() == 0
        assert pos.dtype == torch.int32 and int(pos) == int(jc["pos"]) \
            == s + i
        tok = np.argmax(out[-1][0], -1).astype(np.int32)
        jc, jl = decode(jp, cfg_j, jc, jnp.asarray(tok))
        new, tl = api.decode_step(tp, cfg_t, tc, torch.from_numpy(tok))
        assert new["pos"] is not pos and int(pos) == s + i
        tc = new
        out.append((np.asarray(jl, np.float32), tl))
    assert int(tc["pos"]) == int(jc["pos"]) == s + steps
    greedy = np.stack([np.argmax(w, -1) for w, _ in out], axis=1)
    return out, (jc, tc), greedy
