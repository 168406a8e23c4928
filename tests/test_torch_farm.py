"""The port's engine farm (``FenixConfig(driver="farm")``) is
bit-identical to the reference's on the CPU: verdicts, every stats key
(``served_per_engine``, ``dropped_eq``, ``engine_q_depth_hist``) and the
final stacked state, queues, delay lines and engine queues, for E in
{1, 2, 4} and P in {1, 2, 4}, ByLenModel and int8_cnn_tiny, the "ref"
gate, a skewed stream (frozen pipes and tails), a slow engine (the
bucket binds), ``serve_max`` binding, the switch tree and oracle
payloads; the farm at E=1 is the port's pipes driver, and the
always-masked step the unmasked one.  Unit parity: the engine-queue ops
of ``vector_io``, ``route_ranks``, ``gather_results``,
``depth_histogram``, ``macs_per_inference`` and ``CycleModel``.

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
from repro.configs import fenix_models as jfm  # noqa: E402
from repro.core.data_engine import state as jstate  # noqa: E402
from repro.core.data_engine.decision_tree import (  # noqa: E402
    fit_tree as j_fit_tree, tree_arrays as j_tree_arrays)
from repro.core.fenix import FenixConfig as JFenixConfig  # noqa: E402
from repro.core.fenix import FenixSystem as JFenixSystem  # noqa: E402
from repro.core.model_engine import engine_farm as jfarm  # noqa: E402
from repro.core.model_engine import inference as jinf  # noqa: E402
from repro.core.model_engine import vector_io as jvio  # noqa: E402
from repro.data import synthetic_traffic as jst  # noqa: E402
from repro_torch.configs import fenix_models as tfm  # noqa: E402
from repro_torch.core.data_engine import state as tstate  # noqa: E402
from repro_torch.core.data_engine.decision_tree import (  # noqa: E402
    tree_arrays)
from repro_torch.core.fenix import (FenixConfig, FenixSystem,  # noqa: E402
                                    _make_pipe_local)
from repro_torch.core.model_engine import delay_line as dl  # noqa: E402
from repro_torch.core.model_engine import engine_farm as farm  # noqa: E402
from repro_torch.core.model_engine import inference as tinf  # noqa: E402
from repro_torch.core.model_engine import vector_io as vio  # noqa: E402

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


SLOW = ({"fpga_hz": 50.0}, {"queue_len": 64},
        {"n_est": 50, "q_est_pps": 2e4})
# name -> (num_pipes, num_engines, model, trace kind, with tree, with
# oracle, engine kw, io kw, system kw, config kw, run_trace calls)
CONFIGS = {
    "p1_e2_bylen_two_calls": (1, 2, "bylen", "trace", False, False, {},
                              {}, {}, {}, 2),
    "p4_e1_int8_oracle_serve_max": (4, 1, "int8", "trace", False, True,
                                    {}, {"serve_max": 8}, {}, {}, 1),
    "p2_e4_skewed_tree_slow": (2, 4, "bylen", "skewed", True, False,
                               *SLOW, {"gate_backend": "ref"}, 1),
}


def _systems(name, int8, tree, oracle, port_only=False, driver="farm"):
    (p, e, model, kind, with_tree, with_oracle, ekw, iokw, skw, ckw,
     _) = CONFIGS[name]
    jmodel, tmodel = (jinf.ByLenModel(), tinf.ByLenModel()) \
        if model == "bylen" else int8
    kw = dict(batch_size=BATCH, control_plane_every=CPE, num_pipes=p,
              num_engines=e if driver == "farm" else 1, driver=driver,
              **ckw)
    port = FenixSystem(
        FenixConfig(engine=tstate.EngineConfig(**ekw),
                    io=vio.IOConfig(**iokw), **kw), tmodel,
        tree=tree_arrays(tree) if with_tree else None, device="cpu",
        oracle_windows=oracle if with_oracle else None, **skw)
    if port_only:
        return port
    ref = JFenixSystem(
        JFenixConfig(engine=jstate.EngineConfig(**ekw),
                     io=jvio.IOConfig(**iokw), **kw), jmodel,
        tree=j_tree_arrays(tree) if with_tree else None,
        oracle_windows=oracle if with_oracle else None, **skw)
    return ref, port


def _stream(name, trace):
    p, kind, ekw = CONFIGS[name][0], CONFIGS[name][3], CONFIGS[name][6]
    if kind == "skewed":
        return skewed(dict(trace), tstate.EngineConfig(**ekw), p)
    return dict(trace)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_farm_replay_matches_reference(name, trace, int8, tree, oracle):
    ref, port = _systems(name, int8, tree, oracle)
    stream = _stream(name, trace)
    n = len(stream["ts_us"])
    cuts = np.linspace(0, n, CONFIGS[name][-1] + 1).astype(int)
    for lo, hi in zip(cuts, cuts[1:]):
        part = {k: v[lo:hi] for k, v in stream.items()}
        v_ref = np.asarray(ref.run_trace(dict(part))["verdict"])
        v = port.run_trace(dict(part))["verdict"]
        assert v.dtype == np.int32 and np.array_equal(v, v_ref), (lo, hi)
        assert_pipes_run_same(ref, port, f"{name} after [{lo}, {hi})")
    assert port.host_syncs == 0 and port.capture_s == 0.0
    st = ref.stats
    assert st["inferences"] == sum(st["served_per_engine"]) > 0
    assert sum(map(sum, st["engine_q_depth_hist"])) > 0
    if CONFIGS[name][1] > 1:
        assert min(st["served_per_engine"]) > 0          # every engine
    if name == "p2_e4_skewed_tree_slow":
        _, _, per_pipe = port._route_pipes(stream)
        assert len(set((per_pipe // BATCH).tolist())) > 1   # frozen pipes
        assert st["tree_pkts"] > 0
        assert 0 < st["granted"] < n // 2                   # binds
    if name == "p4_e1_int8_oracle_serve_max":
        assert st["inferences"] < st["granted"]             # binds


@pytest.mark.parametrize("name", ["p4_e1_int8_oracle_serve_max",
                                  "p2_e4_skewed_tree_slow",
                                  "p1_e2_bylen_two_calls"])
def test_farm_at_one_engine_is_the_pipes_driver(name, trace, int8, tree,
                                                oracle):
    """driver="farm" at num_engines=1 == the port's pipes driver on the
    same configuration: verdicts, stats and the stacked carry."""
    farm1 = _systems(name, int8, tree, oracle, port_only=True)
    if farm1.cfg.num_engines != 1:
        cfg = farm1.cfg
        farm1 = FenixSystem(FenixConfig(
            engine=cfg.engine, io=cfg.io, batch_size=BATCH,
            control_plane_every=CPE, num_pipes=cfg.num_pipes,
            driver="farm"), farm1.model, tree=farm1.tree, device="cpu",
            oracle_windows=farm1.oracle, n_est=farm1.n_est,
            q_est_pps=farm1.q_est_pps)
    pipes = _systems(name, int8, tree, oracle, port_only=True,
                     driver="pipes")
    stream = _stream(name, trace)
    assert np.array_equal(farm1.run_trace(dict(stream))["verdict"],
                          pipes.run_trace(dict(stream))["verdict"])
    assert farm1.stats == pipes.stats
    for name_ in ("pstate", "pqueues", "pdl"):
        assert_same(getattr(pipes, name_), getattr(farm1, name_), name_)


def test_always_masked_farm_step_is_the_unmasked_step():
    """The masked farm step with every pipe active gives exactly the
    unmasked step's carry, verdicts, stats, served counts and depths."""
    p, e = 2, 3
    cfg = FenixConfig(batch_size=BATCH, num_pipes=p, num_engines=e,
                      io=vio.IOConfig(queue_len=64, serve_max=32))
    gcfg = tstate.farm_engine_config(cfg.engine, e)
    lcfg = tstate.local_engine_config(gcfg, p)
    step = farm.make_farm_step(
        p, e, cfg.io, cfg.engine.token_rate_per_us, 3,
        _make_pipe_local(lcfg, cfg.io, None, 4), tinf.ByLenModel(), lcfg)
    runs = []
    for active in (None, torch.ones(p, dtype=torch.bool)):
        carry = (tstate.init_pipes_state(gcfg, p),
                 vio.init_pipes_queues(cfg.io, p),
                 dl.init_pipes(cfg.io.queue_len * e, p),
                 vio.init_engine_queues(cfg.io, e, p))
        outs = []
        rng = np.random.default_rng(2)
        for i in range(3):
            chunk = stacked_packets(rng, p, BATCH)[1]
            carry, *out = step(carry, chunk, i == 1, active)
            outs.append(out)
        runs.append((carry, outs))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert_same(dict(a), dict(b), "carry")
    for oa, ob in zip(runs[0][1], runs[1][1]):
        assert all(torch.equal(x, y) for x, y in zip(oa, ob))
    assert int(runs[0][1][-1][2].sum()) > 0        # engines served


# -- unit parity ------------------------------------------------------------

def test_engine_intake_and_queues_match_reference():
    rng = np.random.default_rng(2)
    for _ in range(60):
        e = int(rng.integers(1, 6))
        free = rng.integers(0, 300, e).astype(np.int32)
        n = np.int32(rng.integers(0, 900))
        assert_same(jvio.engine_intake(jnp.asarray(free), jnp.asarray(n)),
                    vio.engine_intake(torch.from_numpy(free),
                                      torch.tensor(n)))
    cfg = jvio.IOConfig(queue_len=8, feat_len=3, feat_dim=2)
    tcfg = vio.IOConfig(queue_len=8, feat_len=3, feat_dim=2)
    e, p, lanes = 3, 2, 10
    jq = jvio.init_engine_queues(cfg, e, p)
    tq = vio.init_engine_queues(tcfg, e, p)
    assert_same(dict(jq), tq, "init")
    for step in range(4):
        valid = rng.random((e, lanes)) < 0.7
        slots = rng.integers(0, 64, (e, lanes)).astype(np.int32)
        hashes = rng.integers(1, 2**32, (e, lanes), dtype=np.uint64)
        feats = rng.integers(0, 99, (e, lanes, 3, 2)).astype(np.int32)
        pipes = rng.integers(0, p, (e, lanes)).astype(np.int32)
        jq = jax.vmap(lambda q, v, s, h, f, pp: jvio.enqueue_engine(
            q, cfg, p, v, s, h, f, pp))(
            jq, *(jnp.asarray(x) for x in (valid, slots,
                                           hashes.astype(np.uint32), feats,
                                           pipes)))
        tq = vio.enqueue_engine(tq, tcfg, p, *(torch.from_numpy(x) for x in (
            valid, slots, hashes.astype(np.int64), feats, pipes)))
        assert_same(dict(jq), tq, f"enqueue {step}")
        assert_same(jax.vmap(lambda q: jvio.engine_free(q, cfg, p))(jq),
                    vio.engine_free(tq, tcfg, p), f"free {step}")
        budget = np.int32(rng.integers(0, 9))
        jq, *jout = jax.vmap(lambda q: jvio.dequeue_engine(
            q, cfg, p, jnp.asarray(budget)))(jq)
        tq, *tout = vio.dequeue_engine(tq, tcfg, p, torch.tensor(budget))
        assert_same(dict(jq), tq, f"dequeue {step}")
        assert_same(jout, tout, f"lanes {step}")


def test_route_ranks_and_gather_results_match_reference():
    """route_ranks for every engine at once and gather_results for every
    pipe at once, against the reference's per-engine / per-pipe calls."""
    rng = np.random.default_rng(6)
    for p, e, lanes, s in [(1, 2, 5, 4), (3, 1, 4, 6), (4, 4, 7, 8),
                           (2, 3, 11, 3)] * 2:
        shares = rng.integers(0, lanes + 1, p).astype(np.int32)
        intake = np.array(jvio.engine_intake(
            jnp.asarray(rng.integers(0, 40, e).astype(np.int32)),
            jnp.asarray(shares.sum())))
        start = (np.cumsum(intake) - intake).astype(np.int32)
        port = farm.route_ranks(torch.from_numpy(shares), p * lanes,
                                torch.from_numpy(start),
                                torch.from_numpy(intake))
        for q in range(e):
            ref = jfarm.route_ranks(jnp.asarray(shares), p * lanes,
                                    jnp.asarray(start[q]),
                                    jnp.asarray(intake[q]))
            valid = np.asarray(ref[2])
            assert_same(valid, port[2][q])
            for a, b in zip(ref[:2], port[:2]):     # the lanes that count
                assert_same(np.asarray(a)[valid], b[q].numpy()[valid])
        res_pipe = rng.integers(0, p, (e, s)).astype(np.int32)
        res_n = rng.integers(0, s + 1, e).astype(np.int32)
        vals = (rng.integers(0, 99, (e, s)).astype(np.int32),
                rng.integers(1, 2**32, (e, s), dtype=np.uint64))
        packed, cnt = farm.gather_results(
            torch.from_numpy(res_pipe), torch.from_numpy(res_n),
            torch.arange(p, dtype=torch.int32),
            (torch.from_numpy(vals[0]),
             torch.from_numpy(vals[1].astype(np.int64))))
        for q in range(p):
            rp, rc = jfarm.gather_results(
                jnp.asarray(res_pipe), jnp.asarray(res_n), jnp.asarray(q),
                (jnp.asarray(vals[0]), jnp.asarray(vals[1].astype(
                    np.uint32))))
            assert_same(rc, cnt[q])
            assert_same(list(rp), [x[q] for x in packed])


def test_depth_histogram_and_cycle_model_match_reference():
    rng = np.random.default_rng(1)
    for e in (1, 3):
        d = rng.integers(0, 1 << 17, (50, e))
        d[:5] = 0
        assert farm.depth_histogram(d, e) == jfarm.depth_histogram(d, e)
    assert farm.DEPTH_BUCKETS == jfarm.DEPTH_BUCKETS
    for name in ("fenix_cnn", "fenix_rnn", "fenix_cnn_tiny",
                 "fenix_rnn_tiny"):
        jc, tc = getattr(jfm, name)(), getattr(tfm, name)()
        assert tinf.macs_per_inference(tc) == jinf.macs_per_inference(jc)
        jm, tm = jinf.CycleModel(), tinf.CycleModel()
        assert tm.latency_us(tc) == jm.latency_us(jc)
        for e in (1, 4):
            assert tm.farm_throughput_inf_per_s(tc, e) == \
                jm.farm_throughput_inf_per_s(jc, e)
            assert tm.farm_batch_latency_us(tc, 100, e) == \
                jm.farm_batch_latency_us(jc, 100, e)


def test_infer_engines_matches_reference(int8):
    jmodel, tmodel = int8
    rng = np.random.default_rng(0)
    pay = rng.integers(0, 1500, (3, 20, 9, 2)).astype(np.int32)
    assert_same(jmodel.infer_engines(jnp.asarray(pay)),
                tmodel.infer_engines(torch.from_numpy(pay)))
    assert_same(jinf.ByLenModel().infer_engines(jnp.asarray(pay)),
                tinf.ByLenModel().infer_engines(torch.from_numpy(pay)))
