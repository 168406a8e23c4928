"""The port's data plane and Model-Engine plumbing are bit-identical to
the reference: hash_five_tuple, process_batch_fast and the exact scan
process_batch (whole state dict, leaf by leaf, on batches whose slots
repeat heavily), the per-packet stages (flow tracker, rate limiter,
buffer manager), the switch decision tree, the control-plane update,
the Vector-I/O ring ops (device and host), the delay line, and the
numpy-only checkpoint reader."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same, to_numpy  # noqa: E402
from repro.configs.fenix_models import fenix_cnn_tiny  # noqa: E402
from repro.core.data_engine import buffer_manager as jbm  # noqa: E402
from repro.core.data_engine import decision_tree as jdt  # noqa: E402
from repro.core.data_engine import engine as jde  # noqa: E402
from repro.core.data_engine import flow_tracker as jft  # noqa: E402
from repro.core.data_engine import rate_limiter as jrl  # noqa: E402
from repro.core.data_engine import state as jstate  # noqa: E402
from repro.core.model_engine import delay_line as jdl  # noqa: E402
from repro.core.model_engine import serving as jserving  # noqa: E402
from repro.core.model_engine import vector_io as jvio  # noqa: E402
from repro.data.synthetic_traffic import (make_flows,  # noqa: E402
                                          windows_from_flows)
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant.quantize import quantize_traffic  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.data_engine import buffer_manager as bm  # noqa: E402
from repro_torch.core.data_engine import decision_tree as dt  # noqa: E402
from repro_torch.core.data_engine import engine as de  # noqa: E402
from repro_torch.core.data_engine import flow_tracker as ft  # noqa: E402
from repro_torch.core.data_engine import rate_limiter as rl  # noqa: E402
from repro_torch.core.data_engine import state as tstate  # noqa: E402
from repro_torch.core.model_engine import delay_line as dl  # noqa: E402
from repro_torch.core.model_engine import serving  # noqa: E402
from repro_torch.core.model_engine import vector_io as vio  # noqa: E402
from repro_torch.data import synthetic_traffic as t_traffic  # noqa: E402

FIVE = ("src_ip", "dst_ip", "src_port", "dst_port", "proto")


def _t(x, dtype=None):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _port_state(jax_state):
    """A reference state dict, carried into the port's dtypes."""
    return {k: _t(v) for k, v in jax_state.items()}


def test_hash_five_tuple_matches_jax():
    pk = jstate.make_packets(np.random.default_rng(0), 20_000)
    pk["src_ip"][:5] = [0, 1, 2**32 - 1, 2**31, 0x9E3779B1]
    ref = jstate.hash_five_tuple(*(jnp.asarray(pk[k]) for k in FIVE))
    port = tstate.hash_five_tuple(*(_t(pk[k]) for k in FIVE))
    assert_same(ref, port)


def _batches(rng, n_flows, n, steps, gap):
    """Consecutive batches drawn from few flows, so slots repeat
    heavily (and distinct flows may share a slot)."""
    flows = jstate.make_packets(rng, n_flows)
    t = 1000
    for _ in range(steps):
        pick = rng.integers(0, n_flows, n)
        pk = {k: flows[k][pick] for k in FIVE}
        pk["pkt_len"] = rng.integers(40, 1500, n).astype(np.int32)
        t_next = t + rng.integers(1, gap * n)
        pk["ts_us"] = np.sort(rng.integers(t, t_next, n)).astype(np.int32)
        t = int(t_next)
        yield pk


@pytest.mark.parametrize("fpga_hz,n_flows,n", [(75e6, 6, 256),
                                               (2e5, 40, 300),
                                               (1e6, 3, 64)])
def test_process_batch_fast_matches_jax(fpga_hz, n_flows, n):
    """Whole state + every output, batch after batch, with control-plane
    rollovers in between; the slow engines make the bucket bind."""
    jcfg = jstate.EngineConfig(n_slots_log2=6, fpga_hz=fpga_hz)
    tcfg = tstate.EngineConfig(n_slots_log2=6, fpga_hz=fpga_hz)
    js = jstate.init_state(jcfg, n_est=20, q_est_pps=5e4)
    ts_ = tstate.init_state(tcfg, n_est=20, q_est_pps=5e4, device="cpu")
    assert_same(js, ts_, "init")
    rng = np.random.default_rng(int(fpga_hz) + n)
    granted = denied = 0
    for i, pk in enumerate(_batches(rng, n_flows, n, 8, gap=3)):
        js, jout = jde.process_batch_fast(
            js, {k: jnp.asarray(v) for k, v in pk.items()}, jcfg)
        ts_, tout = de.process_batch_fast(
            ts_, {k: _t(v) for k, v in pk.items()}, tcfg)
        assert_same(jout, tout, f"out {i}")
        assert_same(js, ts_, f"state {i}")
        g = int(np.asarray(jout["granted"]).sum())
        granted, denied = granted + g, denied + n - g
        if i % 3 == 2:
            js = jrl.control_plane_update(js, jcfg)
            ts_ = rl.control_plane_update(ts_, tcfg)
            assert_same(js, ts_, f"control plane {i}")
    assert granted > 0
    if fpga_hz < 1e6:           # the token bucket binds
        assert denied > 0


def _plain_draw_case(pipes, n=48, seed=5):
    """The reference's and the port's stacked state of P pipes and one
    batch [P, n] (n_est 500, q_est 1e6: the LUT's probabilities lie
    below 1, so the draws decide grants)."""
    cfg, tcfg = (jstate.EngineConfig(n_slots_log2=6, fpga_hz=2e5),
                 tstate.EngineConfig(n_slots_log2=6, fpga_hz=2e5))
    pk = tstate.make_packets(np.random.default_rng(seed), pipes * n)
    pk = {k: v.reshape(pipes, n) for k, v in pk.items()}
    pk["ts_us"] = np.sort(pk["ts_us"], axis=-1)
    est = dict(n_est=500, q_est_pps=1e6)
    return ((jstate.local_engine_config(cfg, pipes),
             jstate.init_pipes_state(cfg, pipes, **est), pk),
            (tstate.local_engine_config(tcfg, pipes),
             tstate.init_pipes_state(tcfg, pipes, device="cpu", **est),
             {k: _t(v) for k, v in pk.items()}))


@pytest.mark.parametrize("gate_backend", ["ref", None])
@pytest.mark.parametrize("pipes", [1, 4])
def test_cpu_step_draws_with_the_plain_threefry(pipes, gate_backend,
                                                monkeypatch):
    """On CPU tensors ("ref", or None, which resolves to it) each step of
    process_pipes_fast draws with one prng.split and one prng.randint and
    never calls the threefry_draw kernel; over three steps its grants,
    rng_key' and bucket' are the reference's process_pipes_fast's."""
    from repro_torch.kernels.rate_gate import kernel as gate_kernel

    (jcfg, js, pk), (cfg, state, tpk) = _plain_draw_case(pipes)
    cfg = dataclasses.replace(cfg, gate_backend=gate_backend)
    calls, depth = [], [0]

    def spy(name, fn):              # records the step's own calls only
        def call(*a, **kw):
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    calls.append(name)
        return call

    def kernel(*a, **kw):
        raise AssertionError("the threefry_draw kernel ran on the CPU")

    monkeypatch.setattr(prng, "split", spy("split", prng.split))
    monkeypatch.setattr(prng, "randint", spy("randint", prng.randint))
    monkeypatch.setattr(gate_kernel, "threefry_draw", kernel)
    granted = 0
    for step in range(3):
        calls.clear()
        js, jout = jde.process_pipes_fast(
            js, {k: jnp.asarray(v) for k, v in pk.items()}, jcfg)
        state, out = de.process_pipes_fast(state, tpk, cfg)
        assert calls == ["split", "randint"], calls
        assert_same(jout["granted"], out["granted"], f"granted {step}")
        for k in ("rng_key", "bucket"):
            assert_same(js[k], state[k], f"{k} {step}")
        granted += int(out["granted"].sum())
        pk["ts_us"] = pk["ts_us"] + 200
        tpk["ts_us"] = tpk["ts_us"] + 200
    assert 0 < granted < 3 * 48 * pipes


def _ring_values(rng, n, feat_len=9):
    return dict(slots=rng.integers(0, 100, n).astype(np.int32),
                hashes=rng.integers(1, 2**32, n, dtype=np.int64
                                    ).astype(np.uint32),
                feats=rng.integers(0, 50, (n, feat_len, 2)
                                   ).astype(np.int32))


def test_vector_io_enqueue_dequeue_match_jax():
    jcfg, tcfg = jvio.IOConfig(queue_len=16), vio.IOConfig(queue_len=16)
    jq, tq = jvio.init_queues(jcfg), vio.init_queues(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    n = 12                      # fixed lanes: one trace of each JAX op
    for step in range(40):
        valid = rng.random(n) < rng.uniform(0.2, 0.9)
        v = _ring_values(rng, n)
        jq = jvio.enqueue_device(jq, jcfg, jnp.asarray(valid),
                                 jnp.asarray(v["slots"]),
                                 jnp.asarray(v["hashes"]),
                                 jnp.asarray(v["feats"]))
        tq = vio.enqueue_device(tq, tcfg, _t(valid), _t(v["slots"]),
                                _t(v["hashes"]), _t(v["feats"]))
        assert_same(jq, tq, f"enqueue {step}")
        budget = np.int32(rng.integers(0, 10))
        jres = jvio.dequeue_device(jq, jcfg, jnp.asarray(budget))
        tres = vio.dequeue_device(tq, tcfg, _t(budget))
        assert_same(list(jres), list(tres), f"dequeue {step}")
        jq, tq = jres[0], tres[0]


def test_step_budget_matches_jax():
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 2**30, 500).astype(np.int32)
    hi = (lo + rng.integers(-5, 2**24, 500)).astype(np.int32)
    for rate in (0.5859375, 75.0, 1e-3):
        for a, b in zip(lo, hi):
            ref = jvio.step_budget(jnp.asarray(a), jnp.asarray(b), rate,
                                   1024)
            assert_same(ref, vio.step_budget(_t(a), _t(b), rate, 1024))


def test_delay_line_push_deliver_match_jax():
    """Duplicate slots (last queued result wins), hash ownership and
    overflow drops, against the reference delay line."""
    n_slots, cap = 32, 24
    rng = np.random.default_rng(5)
    cfg = jstate.EngineConfig(n_slots_log2=5)
    js = jstate.init_state(cfg)
    js["hash"] = jnp.asarray(rng.integers(1, 2**32, n_slots, dtype=np.int64
                                          ).astype(np.uint32))
    ts_ = _port_state(js)
    jline, tline = jdl.init(cap), dl.init(cap, device="cpu")
    now = 100
    n = 15
    for step in range(30):
        slots = rng.integers(0, n_slots, n).astype(np.int32)
        own = np.asarray(js["hash"])[slots]
        hashes = np.where(rng.random(n) < 0.8, own,
                          own ^ np.uint32(1)).astype(np.uint32)
        cls = rng.integers(0, 7, n).astype(np.int32)
        count = np.int32(rng.integers(0, n + 1))
        due = np.int32(now + rng.integers(0, 6))
        jline = jdl.push(jline, jnp.asarray(due), jnp.asarray(slots),
                         jnp.asarray(hashes), jnp.asarray(cls),
                         jnp.asarray(count))
        tline = dl.push(tline, _t(due), _t(slots), _t(hashes), _t(cls),
                        _t(count))
        assert_same(jline, tline, f"push {step}")
        now += int(rng.integers(0, 2))
        js, jline = jdl.deliver(js, jline, jnp.asarray(now, jnp.int32),
                                n_slots)
        ts_, tline = dl.deliver(ts_, tline, _t(np.int32(now)), n_slots)
        assert_same(jline, tline, f"deliver line {step}")
        assert_same(js["cls"], ts_["cls"], f"deliver cls {step}")
    assert int(np.asarray(jline["dropped"])) > 0
    assert int((np.asarray(js["cls"]) >= 0).sum()) > 0


def test_apply_inference_result_matches_jax():
    """A verdict lands only while the slot still holds the flow's hash."""
    cfg = jstate.EngineConfig(n_slots_log2=4)
    js = jstate.init_state(cfg)
    js["hash"] = jnp.arange(1, 17, dtype=jnp.uint32) * jnp.uint32(2**28)
    ts_ = _port_state(js)
    rng = np.random.default_rng(7)
    for step in range(12):
        slot = np.int32(rng.integers(0, 16))
        h = np.uint32(np.asarray(js["hash"])[slot] ^ (step % 3 == 0))
        cls = np.int32(rng.integers(0, 7))
        js = jft.apply_inference_result(js, jnp.asarray(slot),
                                        jnp.asarray(cls), jnp.asarray(h))
        ts_ = ft.apply_inference_result(ts_, _t(slot), _t(cls), _t(h))
        assert_same(js["cls"], ts_["cls"], f"step {step}")


def test_load_quantized_reads_reference_checkpoint(tmp_path):
    """A checkpoint written by the reference's save_quantized loads with
    numpy alone, and carries across unchanged."""
    cfg = fenix_cnn_tiny(num_classes=5)
    x, _, _ = windows_from_flows(make_flows("iscx", 30, seed=1))
    qp = quantize_traffic(jtraffic.init(cfg, seed=2), cfg,
                          jnp.asarray(x[:128]))
    jserving.save_quantized(str(tmp_path), qp, cfg, meta={"note": "t"})
    qp_np, tcfg = serving.load_quantized(tmp_path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert_same(jax.tree.map(np.asarray, qp), qp_np)
    port = serving.qparams_from_numpy(qp_np, "cpu")
    assert sorted(port) == sorted(qp)
    assert isinstance(port["conv0/shift"], int)
    assert port["conv0/w"].dtype == torch.int8
    assert port["cfg_shifts"] == {k: int(v) for k, v in
                                  to_numpy(qp["cfg_shifts"]).items()}
    model = serving.build_model("int8_cnn_tiny", model_dir=tmp_path,
                                device="cpu")
    assert model.cfg.num_classes == 5
    with pytest.raises(FileNotFoundError):
        serving.load_quantized(tmp_path / "missing")
    # without model_dir the factory trains the default instance (the
    # tiny CNN here) and serves it
    default = serving.build_model("int8_cnn_tiny", device="cpu")
    assert isinstance(default, serving.EngineModel)
    assert default.cfg.num_classes == 7 and default.cfg.kind == "cnn"
    assert default.infer(torch.from_numpy(x[:8])).shape == (8,)


def _packet(pk, i, conv):
    return {k: conv(np.asarray(v[i])) for k, v in pk.items()}


def _scalar(x):
    return _t(np.asarray(x))


@pytest.mark.parametrize("fpga_hz,queue_len", [(75e6, 64), (2e4, 2)])
def test_per_packet_stages_match_jax(fpga_hz, queue_len):
    """lookup, on_packet, extract_feature, rl.step, assemble and push —
    each stage's outputs and the whole state after it — packet by
    packet, with control-plane rollovers; the slow engine with a short
    bucket makes the token bucket deny."""
    jcfg = jstate.EngineConfig(n_slots_log2=5, fpga_hz=fpga_hz,
                               queue_len=queue_len)
    tcfg = tstate.EngineConfig(n_slots_log2=5, fpga_hz=fpga_hz,
                               queue_len=queue_len)
    js = jstate.init_state(jcfg, n_est=20, q_est_pps=5e4)
    ts_ = tstate.init_state(tcfg, n_est=20, q_est_pps=5e4, device="cpu")
    rng = np.random.default_rng(int(fpga_hz) % 1000)
    granted = 0
    for b, pk in enumerate(_batches(rng, 12, 40, 3, gap=40)):
        for i in range(40):
            jp, tp = _packet(pk, i, jnp.asarray), _packet(pk, i, _scalar)
            where = f"batch {b} packet {i}"
            jl = jft.lookup(js, jcfg, jp)
            tl = ft.lookup(ts_, tcfg, tp)
            assert_same(list(jl), list(tl), f"lookup {where}")
            ts32 = jp["ts_us"].astype(jnp.int32)
            js = jft.on_packet(js, jcfg, *jl, ts32)
            ts_ = ft.on_packet(ts_, tcfg, *tl, tp["ts_us"])
            assert_same(js, ts_, f"on_packet {where}")
            jf = jbm.extract_feature(js, jcfg, jl[0], jp, jl[2])
            tf = bm.extract_feature(ts_, tcfg, tl[0], tp, tl[2])
            assert_same(jf, tf, f"feature {where}")
            js, jg = jrl.step(js, jcfg, jl[0], ts32)
            ts_, tg = rl.step(ts_, tcfg, tl[0], tp["ts_us"])
            assert_same(jg, tg, f"granted {where}")
            assert_same(js, ts_, f"rl.step {where}")
            assert_same(jbm.assemble(js, jcfg, jl[0], jf),
                        bm.assemble(ts_, tcfg, tl[0], tf),
                        f"assemble {where}")
            js = jbm.push(js, jcfg, jl[0], jf, ts32)
            ts_ = bm.push(ts_, tcfg, tl[0], tf, tp["ts_us"])
            assert_same(js, ts_, f"push {where}")
            granted += int(jg)
        js = jrl.control_plane_update(js, jcfg)
        ts_ = rl.control_plane_update(ts_, tcfg)
    assert 0 < granted
    assert int(js["collisions"]) > 0
    if fpga_hz < 1e6:
        assert int(js["denied_tokens"]) > 0


def test_scalar_draw_is_lane_zero_of_a_batch_draw():
    """rl.step draws randint(sub, ()) in the reference and lane 0 of
    randint(sub, (n,)) in the port: the same value for any key."""
    import jax

    rng = np.random.default_rng(11)
    for seed in [0, 7] + list(rng.integers(0, 2**31, 6)):
        key = jax.random.PRNGKey(int(seed))
        for sub in jax.random.split(key, 3):
            ref = int(jax.random.randint(sub, (), 0, 1 << 16, jnp.int32))
            lane0 = int(jax.random.randint(sub, (5,), 0, 1 << 16,
                                           jnp.int32)[0])
            port = int(prng.randint(_t(np.asarray(sub)), 1, 0, 1 << 16)[0])
            assert ref == lane0 == port, (seed, ref, lane0, port)
    assert int(jax.random.randint(jax.random.PRNGKey(7), (), 0, 1 << 16,
                                  jnp.int32)) == 36639


@pytest.mark.parametrize("with_tree", [False, True])
def test_process_batch_matches_jax(with_tree):
    """The exact scan: whole state + every output, batch after batch."""
    jcfg = jstate.EngineConfig(n_slots_log2=5, fpga_hz=5e5)
    tcfg = tstate.EngineConfig(n_slots_log2=5, fpga_hz=5e5)
    js = jstate.init_state(jcfg, n_est=20, q_est_pps=5e4)
    ts_ = tstate.init_state(tcfg, n_est=20, q_est_pps=5e4, device="cpu")
    rng = np.random.default_rng(3 + with_tree)
    jtree = ttree = None
    if with_tree:
        x = rng.integers(0, 1500, (400, 2)).astype(np.int32)
        y = (x[:, 0] // 300 + (x[:, 1] > 700)).astype(np.int32)
        fit = jdt.fit_tree(x, y, depth=3, num_classes=7)
        jtree, ttree = jdt.tree_arrays(fit), dt.tree_arrays(fit, "cpu")
    for i, pk in enumerate(_batches(rng, 10, 48, 4, gap=20)):
        js, jout = jde.process_batch(
            js, {k: jnp.asarray(v) for k, v in pk.items()}, jcfg,
            tree=jtree, tree_depth=3)
        ts_, tout = de.process_batch(ts_, {k: _t(v) for k, v in pk.items()},
                                     tcfg, tree=ttree, tree_depth=3)
        assert_same(jout, tout, f"out {i}")
        assert_same(js, ts_, f"state {i}")
        assert tout["slot"].dtype == torch.int32
        assert tout["verdict"].dtype == torch.int32
        if i % 2 == 1:
            js = jrl.control_plane_update(js, jcfg)
            ts_ = rl.control_plane_update(ts_, tcfg)
    if with_tree:
        assert int((np.asarray(jout["verdict"]) >= 0).sum()) > 0


def test_fit_tree_and_predict_match_jax():
    """fit_tree (the port's copy) fits the reference's tree from the
    same windows, and predict walks it to the same classes, at depths
    3 and 4 and on batched and scalar features."""
    flows = make_flows("iscx", 30, seed=4)
    x, y, _ = windows_from_flows(flows)
    tx, ty, tf = t_traffic.windows_from_flows(
        t_traffic.make_flows("iscx", 30, seed=4))
    assert np.array_equal(tx, x) and np.array_equal(ty, y)
    feats = x[:, -1, :]
    for depth in (3, 4):
        ref = jdt.fit_tree(feats, y, depth=depth, num_classes=7)
        port = dt.fit_tree(feats, y, depth=depth, num_classes=7)
        for k in ("feature", "threshold", "leaf_class"):
            assert np.array_equal(getattr(ref, k), getattr(port, k)), k
        assert port.depth == ref.depth == depth
        probe = np.concatenate([feats, x[:, 0, :], [[0, 0], [1 << 20,
                                                             1 << 20]]])
        jp = jdt.predict(jdt.tree_arrays(ref), jnp.asarray(probe), depth)
        tp = dt.predict(dt.tree_arrays(ref, "cpu"), _t(probe), depth)
        assert tp.dtype == torch.int32
        assert_same(jp, tp, f"depth {depth}")
        assert len(np.unique(np.asarray(jp))) > 1


def test_vector_io_host_pair_matches_jax():
    """enqueue_batch / dequeue_batch: FIFO order, wraparound and overflow
    drops, against the reference's host pair."""
    jcfg, tcfg = jvio.IOConfig(queue_len=16), vio.IOConfig(queue_len=16)
    jq, tq = jvio.init_queues(jcfg), vio.init_queues(tcfg, device="cpu")
    rng = np.random.default_rng(4)
    for step in range(30):
        v = _ring_values(rng, int(rng.integers(0, 14)))
        jq = jvio.enqueue_batch(jq, jcfg, v["slots"], v["hashes"],
                                v["feats"])
        tq = vio.enqueue_batch(tq, tcfg, v["slots"], v["hashes"].astype(
            np.int64), v["feats"])
        assert_same(jq, tq, f"enqueue {step}")
        assert tq["id_q_hash"].dtype == torch.int64
        assert tq["head"].dtype == torch.int32 and tq["head"].shape == ()
        n = int(rng.integers(0, 12))
        jres = jvio.dequeue_batch(jq, jcfg, n)
        tres = vio.dequeue_batch(tq, tcfg, n)
        assert_same(list(jres), list(tres), f"dequeue {step}")
        jq, tq = jres[0], tres[0]
    assert int(jq["dropped"]) > 0


def test_delay_line_to_list_matches_jax():
    """to_list drains in ring order, across the ring's wraparound."""
    cap = 10
    rng = np.random.default_rng(6)
    jline, tline = jdl.init(cap), dl.init(cap, device="cpu")
    js = jstate.init_state(jstate.EngineConfig(n_slots_log2=4))
    ts_ = _port_state(js)
    for step in range(12):
        n = 6
        slots = rng.integers(0, 16, n).astype(np.int32)
        hashes = rng.integers(1, 2**32, n, dtype=np.int64).astype(np.uint32)
        cls = rng.integers(0, 7, n).astype(np.int32)
        count, due = np.int32(rng.integers(0, n + 1)), np.int32(step)
        jline = jdl.push(jline, jnp.asarray(due), jnp.asarray(slots),
                         jnp.asarray(hashes), jnp.asarray(cls),
                         jnp.asarray(count))
        tline = dl.push(tline, _t(due), _t(slots), _t(hashes), _t(cls),
                        _t(count))
        assert dl.to_list(tline) == jdl.to_list(jline), step
        js, jline = jdl.deliver(js, jline, jnp.asarray(step - 2, jnp.int32),
                                16)
        ts_, tline = dl.deliver(ts_, tline, _t(np.int32(step - 2)), 16)
    assert len(jdl.to_list(jline)) > 0


def test_write_results_is_apply_inference_result_in_order():
    """The host driver's batched write-back equals the reference's
    apply_inference_result run over the due results in list order."""
    cfg = jstate.EngineConfig(n_slots_log2=4)
    js = jstate.init_state(cfg)
    rng = np.random.default_rng(9)
    js["hash"] = jnp.asarray(rng.integers(1, 2**32, 16, dtype=np.int64
                                          ).astype(np.uint32))
    ts_ = _port_state(js)
    for step in range(8):
        n = int(rng.integers(1, 30))
        slots = rng.integers(0, 16, n)
        own = np.asarray(js["hash"])[slots].astype(np.int64)
        hashes = np.where(rng.random(n) < 0.7, own, own ^ 1)
        cls = rng.integers(0, 7, n)
        for s_, h_, c_ in zip(slots, hashes, cls):
            js = jft.apply_inference_result(
                js, jnp.asarray(s_, jnp.int32), jnp.asarray(c_, jnp.int32),
                jnp.asarray(h_, jnp.uint32))
        ts_ = dl.write_results(ts_, _t(slots), _t(hashes), _t(cls),
                               torch.ones(n, dtype=torch.bool), 16)
        assert_same(js["cls"], ts_["cls"], f"step {step}")
