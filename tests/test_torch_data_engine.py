"""The port's data plane and Model-Engine plumbing are bit-identical to
the reference: hash_five_tuple, process_batch_fast (whole state dict,
leaf by leaf, on batches whose slots repeat heavily), the control-plane
update, the Vector-I/O ring ops, the delay line, and the numpy-only
checkpoint reader."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same, to_numpy  # noqa: E402
from repro.configs.fenix_models import fenix_cnn_tiny  # noqa: E402
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
from repro_torch.core.data_engine import engine as de  # noqa: E402
from repro_torch.core.data_engine import flow_tracker as ft  # noqa: E402
from repro_torch.core.data_engine import rate_limiter as rl  # noqa: E402
from repro_torch.core.data_engine import state as tstate  # noqa: E402
from repro_torch.core.model_engine import delay_line as dl  # noqa: E402
from repro_torch.core.model_engine import serving  # noqa: E402
from repro_torch.core.model_engine import vector_io as vio  # noqa: E402

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
    with pytest.raises(NotImplementedError, match="training"):
        serving.build_model("int8_cnn", device="cpu")
