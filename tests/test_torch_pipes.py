"""The port's multi-pipe driver (``FenixConfig(driver="pipes")``) is
bit-identical to the reference's on the CPU: verdicts, every stats key
and the final stacked state, queues and delay lines, for P in {1, 2, 4},
ByLenModel and int8_cnn_tiny, the "ref" gate, a skewed stream (frozen
pipes and tails), a slow engine (the bucket binds), ``serve_max``
binding, the switch tree and oracle payloads; the pipes driver at P=1 is
the port's device driver, and the always-masked step the unmasked one.
Unit parity: the pipe ops of ``state``, ``prng``, the fused admission's
plain version, ``engine.process_pipes_fast``, the control plane,
``vector_io`` and ``delay_line``.

The reference runs through its vmap fallback (``vmap_fallback``: the
mesh functions ``pipe_mesh`` and ``farm_mesh`` monkeypatched to return
None, in these tests only).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (assert_pipes_run_same, assert_same,  # noqa: E402
                           skewed, stacked_packets, tiny_int8_pair,
                           vmap_fallback)
from repro.core.data_engine import engine as jde  # noqa: E402
from repro.core.data_engine import rate_limiter as jrl  # noqa: E402
from repro.core.data_engine import state as jstate  # noqa: E402
from repro.core.data_engine.decision_tree import (  # noqa: E402
    fit_tree as j_fit_tree, tree_arrays as j_tree_arrays)
from repro.core.fenix import FenixConfig as JFenixConfig  # noqa: E402
from repro.core.fenix import FenixSystem as JFenixSystem  # noqa: E402
from repro.core.model_engine import delay_line as jdl  # noqa: E402
from repro.core.model_engine import vector_io as jvio  # noqa: E402
from repro.core.model_engine.inference import (  # noqa: E402
    ByLenModel as JByLenModel)
from repro.data import synthetic_traffic as jst  # noqa: E402
from repro.kernels.rate_gate import ops as jgate  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.data_engine import engine as de  # noqa: E402
from repro_torch.core.data_engine import rate_limiter as rl  # noqa: E402
from repro_torch.core.data_engine import state as tstate  # noqa: E402
from repro_torch.core.data_engine.decision_tree import (  # noqa: E402
    tree_arrays)
from repro_torch.core.fenix import (FenixConfig, FenixSystem,  # noqa: E402
                                    _make_pipes_step)
from repro_torch.core.model_engine import delay_line as dl  # noqa: E402
from repro_torch.core.model_engine import vector_io as vio  # noqa: E402
from repro_torch.core.model_engine.inference import ByLenModel  # noqa: E402
from repro_torch.kernels.rate_gate import ops as tgate  # noqa: E402

# 3000 packets in batches of 256 a pipe, T_w windows of three batches
BATCH, CPE, LIMIT = 256, 3, 3000


@pytest.fixture(scope="module", autouse=True)
def reference_vmap():
    with pytest.MonkeyPatch.context() as mp:
        vmap_fallback(mp)
        yield


@pytest.fixture(scope="module")
def flows():
    return jst.make_flows("iscx", 50, seed=11)


@pytest.fixture(scope="module")
def trace(flows):
    return jst.packet_stream(flows, limit=LIMIT)


@pytest.fixture(scope="module")
def int8(flows):
    return tiny_int8_pair(flows)


@pytest.fixture(scope="module")
def tree(flows):
    x, y, _ = jst.windows_from_flows(flows)
    return j_fit_tree(x[:, -1, :], y, depth=4, num_classes=7)


@pytest.fixture(scope="module")
def oracle(flows):
    return [np.stack([f.pkt_len, f.ipd_us], -1).astype(np.int32)
            for f in flows]


# name -> (num_pipes, model, trace kind, with tree, with oracle, engine
# kw, io kw, system kw, config kw, parts: the trace in that many
# run_trace calls in a row, the second starting from the carry the first
# left).  "slow": a slow Model Engine on which the token bucket binds.
SLOW = ({"fpga_hz": 50.0}, {"queue_len": 64},
        {"n_est": 50, "q_est_pps": 2e4})
CONFIGS = {
    "p1_bylen_two_calls": (1, "bylen", "trace", False, False, {}, {}, {},
                           {}, 2),
    "p2_skewed_tree_slow": (2, "bylen", "skewed", True, False, *SLOW,
                            {"gate_backend": "ref"}, 1),
    "p4_int8_oracle_serve_max": (4, "int8", "trace", False, True, {},
                                 {"serve_max": 8}, {}, {}, 1),
}


def _pair(name, flows, trace, int8, tree, oracle):
    """(reference system, port system, stream) of a configuration."""
    p, model, kind, with_tree, with_oracle, ekw, iokw, skw, ckw, _ = \
        CONFIGS[name]
    jmodel, tmodel = (JByLenModel(), ByLenModel()) if model == "bylen" \
        else int8
    stream = dict(trace)
    if kind == "skewed":
        stream = skewed(stream, tstate.EngineConfig(**ekw), p)
    kw = dict(batch_size=BATCH, control_plane_every=CPE, num_pipes=p,
              driver="pipes", **ckw)
    ref = JFenixSystem(
        JFenixConfig(engine=jstate.EngineConfig(**ekw),
                     io=jvio.IOConfig(**iokw), **kw), jmodel,
        tree=j_tree_arrays(tree) if with_tree else None,
        oracle_windows=oracle if with_oracle else None, **skw)
    port = FenixSystem(
        FenixConfig(engine=tstate.EngineConfig(**ekw),
                    io=vio.IOConfig(**iokw), **kw), tmodel,
        tree=tree_arrays(tree) if with_tree else None, device="cpu",
        oracle_windows=oracle if with_oracle else None, **skw)
    return ref, port, stream


def run_parts(ref, port, stream, parts):
    """The stream replayed in ``parts`` run_trace calls on both systems:
    the verdicts equal after each, and the whole carry."""
    n = len(stream["ts_us"])
    cuts = np.linspace(0, n, parts + 1).astype(int)
    for lo, hi in zip(cuts, cuts[1:]):
        part = {k: v[lo:hi] for k, v in stream.items()}
        v_ref = np.asarray(ref.run_trace(dict(part))["verdict"])
        v = port.run_trace(dict(part))["verdict"]
        assert v.dtype == np.int32 and v.shape == v_ref.shape
        assert np.array_equal(v, v_ref), (lo, hi)
        assert_pipes_run_same(ref, port, f"after [{lo}, {hi})")
    assert port.host_syncs == 0 and port.capture_s == 0.0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipes_replay_matches_reference(name, flows, trace, int8, tree,
                                        oracle):
    ref, port, stream = _pair(name, flows, trace, int8, tree, oracle)
    run_parts(ref, port, stream, CONFIGS[name][-1])
    st = ref.stats
    assert st["inferences"] > 0 and st["classified_pkts"] > 0
    if name == "p1_bylen_two_calls":
        # the host-driven rollover of every pipe (the oracle's path)
        ref.control_plane_pipes()
        port.control_plane_pipes()
        assert_same(dict(ref.pstate), port.pstate, "control_plane_pipes")
        assert port.host_syncs == ref.host_syncs == 1
        with pytest.raises(RuntimeError, match="run_trace"):
            port.step({k: v[:BATCH] for k, v in stream.items()})
    if name == "p2_skewed_tree_slow":
        _, _, per_pipe = port._route_pipes(stream)
        assert len(set((per_pipe // BATCH).tolist())) > 1   # frozen pipes
        assert (per_pipe % BATCH).all()                     # every tail
        assert st["tree_pkts"] > 0
        assert 0 < st["granted"] < len(stream["ts_us"]) // 2    # binds
    if name == "p4_int8_oracle_serve_max":                   # binds
        assert st["inferences"] < st["granted"]
        assert int((port.pqueues["tail"] - port.pqueues["head"]).sum()) > 0


def test_pipes_at_one_pipe_is_the_device_driver(flows, trace, int8, tree,
                                                oracle):
    """driver="pipes" at num_pipes=1 == the port's device driver:
    verdicts, stats and the whole carry."""
    _, pipes, stream = _pair("p1_bylen_two_calls", flows, trace, int8, tree,
                             oracle)
    device = FenixSystem(FenixConfig(batch_size=BATCH,
                                     control_plane_every=CPE), ByLenModel(),
                         device="cpu")
    assert np.array_equal(pipes.run_trace(dict(stream))["verdict"],
                          device.run_trace(dict(stream))["verdict"])
    assert pipes.stats == device.stats
    for mine, theirs in (("pstate", "state"), ("pqueues", "queues"),
                         ("pdl", "_dl")):
        a, b = getattr(pipes, mine), getattr(device, theirs)
        assert_same({k: v[0] for k, v in a.items()}, dict(b), mine)


def _pipes_inputs(num_pipes, steps, seed):
    rng = np.random.default_rng(seed)
    return [stacked_packets(rng, num_pipes, BATCH)[1] for _ in range(steps)]


def test_always_masked_step_is_the_unmasked_step():
    """The masked step with every pipe active gives exactly the unmasked
    step's carry, verdicts and stats (the graphs capture the masked one
    for every uniform step), over steps with and without the control
    plane."""
    cfg = FenixConfig(batch_size=BATCH, num_pipes=4, driver="pipes")
    lcfg = tstate.local_engine_config(cfg.engine, 4)
    step = _make_pipes_step(cfg, lcfg, ByLenModel(), None, 4)
    runs = []
    for active in (None, torch.ones(4, dtype=torch.bool)):
        carry = (tstate.init_pipes_state(cfg.engine, 4),
                 vio.init_pipes_queues(cfg.io, 4), dl.init_pipes(
                     cfg.io.queue_len, 4))
        outs = []
        for i, chunk in enumerate(_pipes_inputs(4, 3, 5)):
            carry, v, st = step(carry, chunk, i == 1, active)
            outs.append((v, st))
        runs.append((carry, outs))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert_same(dict(a), dict(b), "carry")
    for (va, sa), (vb, sb) in zip(runs[0][1], runs[1][1]):
        assert torch.equal(va, vb) and torch.equal(sa, sb)


def test_masked_step_freezes_inactive_pipes():
    """A pipe that is not active keeps its state, queues and line."""
    cfg = FenixConfig(batch_size=BATCH, num_pipes=2, driver="pipes")
    lcfg = tstate.local_engine_config(cfg.engine, 2)
    step = _make_pipes_step(cfg, lcfg, ByLenModel(), None, 4)
    carry = (tstate.init_pipes_state(cfg.engine, 2),
             vio.init_pipes_queues(cfg.io, 2), dl.init_pipes(
                 cfg.io.queue_len, 2))
    before = [{k: v[1].clone() for k, v in c.items()} for c in carry]
    new, _, st = step(carry, _pipes_inputs(2, 1, 9)[0], False,
                      torch.tensor([True, False]))
    for b, c in zip(before, new):
        assert_same(b, {k: v[1] for k, v in c.items()}, "frozen pipe")
    assert int(st[0]) == int(new[0]["granted"][0]) > 0


# -- unit parity ------------------------------------------------------------

def test_pipe_configs_and_state_match_reference():
    for p in (1, 2, 4):
        jcfg, tcfg = jstate.EngineConfig(), tstate.EngineConfig()
        jl = jstate.local_engine_config(jstate.farm_engine_config(jcfg, 2),
                                        p)
        tl = tstate.local_engine_config(tstate.farm_engine_config(tcfg, 2),
                                        p)
        assert (jl.n_slots, jl.cost_us, jl.bucket_cap_us) == \
            (tl.n_slots, tl.cost_us, tl.bucket_cap_us)
        assert np.float32(jl.token_rate_per_us) == \
            np.float32(tl.token_rate_per_us)
        assert_same(dict(jstate.init_pipes_state(jcfg, p, n_est=300,
                                                 q_est_pps=4e5)),
                    tstate.init_pipes_state(tcfg, p, n_est=300,
                                            q_est_pps=4e5), f"P={p}")
    rng = np.random.default_rng(0)
    h = rng.integers(1, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for p in (1, 2, 4, 8):
        want = jstate.pipe_of_hash(h, jstate.EngineConfig(), p)
        assert_same(want, tstate.pipe_of_hash(h, tstate.EngineConfig(), p))
        assert_same(want, tstate.pipe_of_hash(
            torch.from_numpy(h.astype(np.int64)), tstate.EngineConfig(), p))
    with pytest.raises(ValueError, match="power of two"):
        tstate.local_engine_config(tstate.EngineConfig(), 3)


def test_batched_prng_matches_vmapped_jax():
    seeds = [0, 1, 7, 2**31 - 1, 123456789]
    jk = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    tk = torch.stack([prng.PRNGKey(s) for s in seeds])
    for num in (2, 3):
        assert_same(jax.vmap(lambda k: jax.random.split(k, num))(jk),
                    prng.split(tk, num), f"split {num}")
    for lo, hi in ((0, 1 << 16), (-5, 100)):
        want = jax.vmap(lambda k: jax.random.randint(k, (333,), lo, hi,
                                                     jnp.int32))(jk)
        assert_same(want, prng.randint(tk, 333, lo, hi), f"[{lo}, {hi})")


@pytest.mark.parametrize("binding", [False, True])
def test_pipe_batched_fused_admission_matches_vmapped_reference(binding):
    """The plain fused admission over [P, n] against the reference's
    fused admission vmapped over pipes: per-pipe LUTs, registers and
    draws; with ``binding`` a small bucket in one pipe only, so the
    credit check denies there and not elsewhere."""
    rng = np.random.default_rng(3 + binding)
    p, n = 4, 777
    t_i = rng.integers(0, 70000, (p, n)).astype(np.int32)
    c_i = rng.integers(0, 40, (p, n)).astype(np.int32)
    ts = np.sort(rng.integers(1, 50000, (p, n)), axis=1).astype(np.int32)
    lut = rng.integers(0, 1 << 16, (p, 64, 32)).astype(np.int32)
    bucket = rng.integers(0, 400, p).astype(np.int32)
    t_last = np.asarray([0, 5, 900, 20], np.int32)
    cost, cap = (40, 400) if not binding else (9, 4000)
    if binding:
        lut[:] = (1 << 16) - 1                  # every lane selected
        bucket[:] = cap
        bucket[2] = 0
        ts[2] = ts[2, 0]                        # no refill: pipe 2 binds
    rand = rng.integers(0, 1 << 16, (p, n)).astype(np.int32)
    kw = dict(cost_us=cost, bucket_cap_us=cap, t_shift=10, c_shift=0)
    ref = jax.vmap(lambda a, b, c, d, e, f, r: jgate.fused_admission(
        a, b, c, d, e, f, rand16=r, backend="ref", **kw))(
        *(jnp.asarray(x) for x in (t_i, c_i, ts, lut, bucket, t_last,
                                   rand)))
    port = tgate.fused_admission(
        *(torch.from_numpy(x) for x in (t_i, c_i, ts, lut, bucket, t_last)),
        rand16=torch.from_numpy(rand), backend="ref", **kw)
    assert_same(ref, port)
    granted = port[0].sum(-1)
    if binding:
        assert int(granted[2]) < n and int(granted[0]) == n
    # the drawing form: each pipe draws from its own key
    keys = torch.stack([prng.PRNGKey(s) for s in range(p)])
    drawn = tgate.fused_admission(
        *(torch.from_numpy(x) for x in (t_i, c_i, ts, lut, bucket, t_last)),
        key=keys, backend="ref", **kw)
    for q in range(p):
        one = tgate.fused_admission(
            *(torch.as_tensor(x[q]) for x in (t_i, c_i, ts, lut, bucket,
                                              t_last)),
            key=keys[q], backend="ref", **kw)
        assert torch.equal(one[0], drawn[0][q]) and \
            torch.equal(one[1], drawn[1][q])


def test_process_pipes_fast_and_control_plane_match_reference():
    """Two batches a pipe through process_pipes_fast, then the per-pipe
    control plane, against the reference's vmaps: every state leaf and
    output; and each pipe's lanes against process_batch_fast on that
    pipe alone."""
    cfg = jstate.EngineConfig(n_slots_log2=7)
    tcfg = tstate.EngineConfig(n_slots_log2=7)
    p = 4
    jl, tl = (jstate.local_engine_config(cfg, p),
              tstate.local_engine_config(tcfg, p))
    rng = np.random.default_rng(8)
    js, ts_ = jstate.init_pipes_state(cfg, p), tstate.init_pipes_state(
        tcfg, p)
    for step in range(2):
        pk, tpk = stacked_packets(rng, p, 200)
        pk["src_ip"][:, ::3] = pk["src_ip"][:, :1]  # repeated flows
        tpk["src_ip"][:, ::3] = tpk["src_ip"][:, :1]
        js, jout = jde.process_pipes_fast(
            js, {k: jnp.asarray(v) for k, v in pk.items()}, jl)
        before = {k: v.clone() for k, v in ts_.items()}
        ts_, tout = de.process_pipes_fast(ts_, tpk, tl)
        assert_same(dict(js), ts_, f"state {step}")
        assert_same(dict(jout), tout, f"out {step}")
        for q in range(p):
            one_s, one_o = de.process_batch_fast(
                {k: v[q] for k, v in before.items()},
                {k: v[q] for k, v in tpk.items()}, tl)
            assert_same(one_o, {k: v[q] for k, v in tout.items()}, q)
            assert_same(one_s, {k: v[q] for k, v in ts_.items()}, q)
    assert_same(dict(jrl.control_plane_update_pipes(js, jl)),
                rl.control_plane_update_pipes(ts_, tl), "control plane")


def test_pipe_shares_and_dequeue_match_reference():
    rng = np.random.default_rng(1)
    for _ in range(60):
        p = int(rng.choice([1, 2, 4, 8]))
        occ = rng.integers(0, 1025, p).astype(np.int32)
        budget = np.int32(rng.integers(0, 5000))
        assert_same(jvio.pipe_shares(jnp.asarray(occ), jnp.asarray(budget)),
                    vio.pipe_shares(torch.from_numpy(occ),
                                    torch.tensor(budget)))
    cfg, tcfg = jvio.IOConfig(queue_len=16), vio.IOConfig(queue_len=16)
    jq, tq = jvio.init_pipes_queues(cfg, 3), vio.init_pipes_queues(tcfg, 3)
    for step in range(3):
        valid = rng.random((3, 10)) < 0.8
        slots = rng.integers(0, 64, (3, 10)).astype(np.int32)
        hashes = rng.integers(1, 2**32, (3, 10), dtype=np.uint64)
        feats = rng.integers(0, 99, (3, 10, 9, 2)).astype(np.int32)
        jq = jax.vmap(lambda q, v, s, h, f: jvio.enqueue_device(
            q, cfg, v, s, h, f))(jq, jnp.asarray(valid), jnp.asarray(slots),
                                 jnp.asarray(hashes.astype(np.uint32)),
                                 jnp.asarray(feats))
        tq = vio.enqueue_device(tq, tcfg, torch.from_numpy(valid),
                                torch.from_numpy(slots),
                                torch.from_numpy(hashes.astype(np.int64)),
                                torch.from_numpy(feats))
        assert_same(dict(jq), tq, f"enqueue {step}")
        shares = rng.integers(0, 12, 3).astype(np.int32)
        jq, *jout = jvio.dequeue_pipes(jq, cfg, jnp.asarray(shares))
        tq, *tout = vio.dequeue_pipes(tq, tcfg, torch.from_numpy(shares))
        assert_same(dict(jq), tq, f"dequeue {step}")
        assert_same(jout, tout, f"lanes {step}")
        assert vio.occupancy({k: v[1] for k, v in tq.items()}) == \
            jvio.occupancy({k: v[1] for k, v in jq.items()})


def test_delay_lines_of_pipes_match_reference():
    """push_pipes / deliver_pipes against the reference's: per-pipe times
    and counts, results delivered into their own pipe's table only."""
    rng = np.random.default_rng(4)
    n_slots = 32
    jst_ = jstate.init_pipes_state(jstate.EngineConfig(n_slots_log2=7), 4)
    tst_ = tstate.init_pipes_state(tstate.EngineConfig(n_slots_log2=7), 4)
    hashes = rng.integers(1, 2**32, (4, n_slots), dtype=np.uint64)
    jst_["hash"] = jnp.asarray(hashes.astype(np.uint32))
    tst_["hash"] = torch.from_numpy(hashes.astype(np.int64))
    jd, td = jdl.init_pipes(16, 4), dl.init_pipes(16, 4)
    for step in range(4):
        slots = rng.integers(0, n_slots, (4, 12)).astype(np.int32)
        h = np.take_along_axis(hashes, slots.astype(np.int64), 1)
        h[:, ::4] += 1                               # some lost ownership
        cls = rng.integers(0, 7, (4, 12)).astype(np.int32)
        cnt = rng.integers(0, 13, 4).astype(np.int32)
        t = (step * 10 + rng.integers(0, 3, 4)).astype(np.int32)
        jd = jdl.push_pipes(jd, jnp.asarray(t), jnp.asarray(slots),
                            jnp.asarray(h.astype(np.uint32)),
                            jnp.asarray(cls), jnp.asarray(cnt))
        td = dl.push_pipes(td, torch.from_numpy(t), torch.from_numpy(slots),
                           torch.from_numpy(h.astype(np.int64)),
                           torch.from_numpy(cls), torch.from_numpy(cnt))
        now = (step * 10 + rng.integers(-5, 5, 4)).astype(np.int32)
        jst_, jd = jdl.deliver_pipes(jst_, jd, jnp.asarray(now), n_slots)
        tst_, td = dl.deliver_pipes(tst_, td, torch.from_numpy(now), n_slots)
        assert_same(dict(jd), td, f"line {step}")
        assert_same(jst_["cls"], tst_["cls"], f"cls {step}")
    assert int((tst_["cls"] >= 0).sum()) > 0
