"""The port's replay of the conformance trace is bit-identical to the
reference's device AND host drivers (verdicts, stats dict, host_syncs,
final LUT, bucket and flow table), for ByLenModel, int8_cnn_tiny and
int8_rnn_tiny with weights carried across; plus the port's import and
device guards.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.configs.fenix_models import (fenix_cnn_tiny,  # noqa: E402
                                        fenix_rnn_tiny)
from repro.core.fenix import FenixConfig as JFenixConfig  # noqa: E402
from repro.core.fenix import FenixSystem as JFenixSystem  # noqa: E402
from repro.core.model_engine.inference import (  # noqa: E402
    ByLenModel as JByLenModel, EngineModel as JEngineModel)
from repro.data.synthetic_traffic import (make_flows,  # noqa: E402
                                          packet_stream, windows_from_flows)
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant.quantize import quantize_traffic  # noqa: E402
from repro_torch.configs.fenix_models import (  # noqa: E402
    fenix_cnn_tiny as t_fenix_cnn_tiny, fenix_rnn_tiny as t_fenix_rnn_tiny)
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine.inference import (  # noqa: E402
    ByLenModel, EngineModel)
from repro_torch.core.model_engine.serving import (  # noqa: E402
    qparams_from_numpy)
from repro_torch.data import synthetic_traffic as t_traffic  # noqa: E402

BATCH, CPE, LIMIT = 256, 3, 1800
ROOT = Path(__file__).resolve().parent.parent
TABLE_KEYS = ("lut", "bucket", "t_last", "hash", "cls", "bklog_n",
              "bklog_t", "buff_idx", "last_ts", "ring", "rng_key",
              "flow_cnt", "win_pkt_cnt", "win_start", "granted")


@pytest.fixture(scope="module")
def trace():
    return packet_stream(make_flows("iscx", 40, seed=7), limit=LIMIT)


@pytest.fixture(scope="module")
def tiny_int8():
    """int8_cnn_tiny: JAX init + quantize (untrained), and the same
    weights carried into the port."""
    cfg = fenix_cnn_tiny()
    x, _, _ = windows_from_flows(make_flows("iscx", 60, seed=3))
    qp = quantize_traffic(jtraffic.init(cfg, seed=0), cfg,
                          jnp.asarray(x[:256]))
    port = EngineModel(t_fenix_cnn_tiny(),
                       qparams_from_numpy(jax.tree.map(np.asarray, qp),
                                          "cpu"))
    return JEngineModel(cfg, qp), port


@pytest.fixture(scope="module")
def tiny_rnn():
    """int8_rnn_tiny, made as ``tiny_int8``."""
    cfg = fenix_rnn_tiny()
    x, _, _ = windows_from_flows(make_flows("iscx", 60, seed=3))
    qp = quantize_traffic(jtraffic.init(cfg, seed=0), cfg,
                          jnp.asarray(x[:256]))
    port = EngineModel(t_fenix_rnn_tiny(),
                       qparams_from_numpy(jax.tree.map(np.asarray, qp),
                                          "cpu"))
    return JEngineModel(cfg, qp), port


def _models(model_name, tiny_int8, tiny_rnn):
    """(reference model, port model) of a served-model name."""
    return {"bylen": (JByLenModel(), ByLenModel()),
            "int8_cnn_tiny": tiny_int8,
            "int8_rnn_tiny": tiny_rnn}[model_name]


_cache = {}


def _reference(trace, driver, model_name, jmodel):
    key = (driver, model_name)
    if key not in _cache:
        sys_ = JFenixSystem(JFenixConfig(batch_size=BATCH,
                                         control_plane_every=CPE,
                                         driver=driver), jmodel)
        out = sys_.run_trace(dict(trace))
        _cache[key] = (np.asarray(out["verdict"]), sys_.stats,
                       sys_.host_syncs, sys_.state)
    return _cache[key]


@pytest.mark.parametrize("driver", ["device", "host"])
@pytest.mark.parametrize("model_name", ["bylen", "int8_cnn_tiny",
                                        "int8_rnn_tiny"])
def test_replay_matches_reference(trace, tiny_int8, tiny_rnn, driver,
                                  model_name):
    jmodel, tmodel = _models(model_name, tiny_int8, tiny_rnn)
    v_ref, s_ref, syncs_ref, st_ref = _reference(trace, driver, model_name,
                                                 jmodel)
    port = FenixSystem(FenixConfig(batch_size=BATCH,
                                   control_plane_every=CPE), tmodel,
                       device="cpu")
    v = port.run_trace(dict(trace))["verdict"]
    assert v.dtype == np.int32 and v.shape == (LIMIT,)
    assert np.array_equal(v, v_ref)
    assert port.stats == s_ref
    assert port.host_syncs == 0
    assert syncs_ref == (0 if driver == "device" else LIMIT // (BATCH * CPE))
    for k in TABLE_KEYS:
        assert_same(st_ref[k], port.state[k], k)
    assert s_ref["inferences"] > 0 and int((v >= 0).sum()) > 0


def test_replay_with_binding_bucket_matches_reference(trace):
    """A slow Model Engine: the token bucket denies grants and the
    Vector-I/O ring fills, on both sides alike."""
    from repro.core.data_engine.state import EngineConfig as JEngineConfig
    from repro.core.model_engine.vector_io import IOConfig as JIOConfig
    from repro_torch.core.data_engine.state import EngineConfig
    from repro_torch.core.model_engine.vector_io import IOConfig

    ref = JFenixSystem(JFenixConfig(
        engine=JEngineConfig(fpga_hz=2e4), io=JIOConfig(queue_len=64),
        batch_size=200, control_plane_every=2, driver="device"),
        JByLenModel(), n_est=50, q_est_pps=2e4)
    v_ref = np.asarray(ref.run_trace(dict(trace))["verdict"])
    port = FenixSystem(FenixConfig(
        engine=EngineConfig(fpga_hz=2e4), io=IOConfig(queue_len=64),
        batch_size=200, control_plane_every=2), ByLenModel(),
        device="cpu", n_est=50, q_est_pps=2e4)
    v = port.run_trace(dict(trace))["verdict"]
    assert np.array_equal(v, v_ref)
    assert port.stats == ref.stats
    assert 0 < ref.stats["granted"] < LIMIT
    for k in TABLE_KEYS:
        assert_same(ref.state[k], port.state[k], k)


def test_port_traffic_generator_matches_reference(trace):
    port = t_traffic.packet_stream(t_traffic.make_flows("iscx", 40, seed=7),
                                   limit=LIMIT)
    assert sorted(port) == sorted(trace)
    for k in trace:
        assert port[k].dtype == trace[k].dtype
        assert np.array_equal(port[k], trace[k]), k


def _port_modules():
    pkg = ROOT / "src" / "repro_torch"
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, importlib\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                     r"(\.|\s))", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FenixSystem(FenixConfig(), ByLenModel())
    with pytest.raises(RuntimeError, match="CUDA"):
        FenixSystem(FenixConfig(), ByLenModel(), device="cuda")


def test_gate_backend_cuda_on_cpu_tensors_raises(trace):
    sys_ = FenixSystem(FenixConfig(batch_size=BATCH, gate_backend="cuda"),
                       ByLenModel(), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sys_.run_trace(dict(trace))


def test_unported_paths_raise(tiny_int8, trace):
    # the pipes and farm drivers are ported (tests/test_torch_pipes.py,
    # tests/test_torch_farm.py): they build, and only the host step raises
    for kw in (dict(driver="pipes", num_pipes=2),
               dict(driver="farm", num_engines=2)):
        sys_ = FenixSystem(FenixConfig(**kw), ByLenModel(), device="cpu")
        with pytest.raises(RuntimeError, match="run_trace"):
            sys_.step(_cut(trace, 0, BATCH))
    with pytest.raises(ValueError, match="power of two"):
        FenixSystem(FenixConfig(driver="pipes", num_pipes=3), ByLenModel(),
                    device="cpu")
    from repro_torch.core.model_engine.serving import build_model

    for name in ("int8_cnn_tiny", "int8_rnn_tiny"):  # the default trains
        model = build_model(name, device="cpu")
        assert isinstance(model, EngineModel)
        sys_ = FenixSystem(FenixConfig(model=name, batch_size=BATCH),
                           device="cpu")
        assert sys_.model.cfg == model.cfg
        v = sys_.run_trace({k: v[:600] for k, v in trace.items()})["verdict"]
        assert v.shape == (600,) and sys_.stats["inferences"] > 0
    with pytest.raises(ValueError, match="unknown gate_backend"):
        FenixConfig(gate_backend="pallas")
    with pytest.raises(ValueError, match="unknown matmul_backend"):
        FenixConfig(matmul_backend="cuda_prng")
    with pytest.raises(ValueError, match="EngineModel"):
        FenixSystem(FenixConfig(matmul_backend="ref"), ByLenModel(),
                    device="cpu")


# -- the in-place chunk step (the body the card captures as a graph) ----------


def _cut(trace, lo, hi):
    return {k: v[lo:hi] for k, v in trace.items()}


def _systems(models, batch, cpe):
    jmodel, tmodel = models
    ref = JFenixSystem(JFenixConfig(batch_size=batch,
                                    control_plane_every=cpe,
                                    driver="device"), jmodel)
    port = FenixSystem(FenixConfig(batch_size=batch, control_plane_every=cpe,
                                   step_backend="eager"), tmodel,
                       device="cpu")
    return ref, port


def _assert_carry_same(ref, port, where):
    assert port.stats == ref.stats, where
    for k in TABLE_KEYS:
        assert_same(ref.state[k], port.state[k], f"{where} {k}")
    assert_same(dict(ref.queues), dict(port.queues), f"{where} queues")
    assert_same(dict(ref._dl), dict(port._dl), f"{where} delay line")


# (batch, cpe): a ragged tail that ends a T_w window (350 x 5 + 50, the
# sixth batch), and a tail that does not after two windows (128 x 14 + 8)
@pytest.mark.parametrize("batch,cpe", [(350, 3), (128, 4)])
@pytest.mark.parametrize("model_name", ["bylen", "int8_cnn_tiny",
                                        "int8_rnn_tiny"])
def test_chunk_step_matches_reference_across_windows_and_tail(
        trace, tiny_int8, tiny_rnn, model_name, batch, cpe):
    """The in-place chunk step, run eagerly, against the reference's
    jitted scan + tail step: verdicts, stats, tables, queues and delay
    line, bit for bit."""
    ref, port = _systems(_models(model_name, tiny_int8, tiny_rnn), batch,
                         cpe)
    v_ref = np.asarray(ref.run_trace(dict(trace))["verdict"])
    v = port.run_trace(dict(trace))["verdict"]
    assert np.array_equal(v, v_ref)
    _assert_carry_same(ref, port, f"{model_name} {batch}/{cpe}")
    assert port.host_syncs == 0 and port.capture_s == 0.0
    assert ref.stats["inferences"] > 0


@pytest.mark.parametrize("model_name", ["bylen", "int8_cnn_tiny",
                                        "int8_rnn_tiny"])
def test_two_run_traces_in_a_row_match_reference(trace, tiny_int8, tiny_rnn,
                                                 model_name):
    """Two replays on one system: the second starts from the carry the
    first left, as the reference's donated carry does."""
    ref, port = _systems(_models(model_name, tiny_int8, tiny_rnn), BATCH,
                         CPE)
    for lo, hi in ((0, 1000), (1000, LIMIT)):
        v_ref = np.asarray(ref.run_trace(_cut(trace, lo, hi))["verdict"])
        assert np.array_equal(port.run_trace(_cut(trace, lo, hi))
                              ["verdict"], v_ref), (lo, hi)
        _assert_carry_same(ref, port, f"{model_name} after [{lo}, {hi})")


def test_host_step_then_device_run_trace_matches_reference(trace,
                                                           tiny_int8):
    """Host steps, then a device replay: the in-flight results of the
    steps go into the device carry, and the replay matches the
    reference's."""
    ref, port = _systems(tiny_int8, BATCH, CPE)
    for lo in (0, BATCH, 2 * BATCH):
        r = ref.step(_cut(trace, lo, lo + BATCH))
        p = port.step(_cut(trace, lo, lo + BATCH))
        assert np.array_equal(np.asarray(r["verdict"]), p["verdict"]), lo
    assert len(port._inflight) > 0
    v_ref = np.asarray(ref.run_trace(_cut(trace, 3 * BATCH, LIMIT))
                       ["verdict"])
    assert np.array_equal(port.run_trace(_cut(trace, 3 * BATCH, LIMIT))
                          ["verdict"], v_ref)
    _assert_carry_same(ref, port, "step then run_trace")


def test_chunk_step_keeps_its_buffers_and_the_system_its_state(trace):
    """The device driver's carry buffers are allocated once and keep
    their addresses across run_trace calls; the system's state after a
    replay is its own copy, which a later replay does not move."""
    port = FenixSystem(FenixConfig(batch_size=BATCH,
                                   control_plane_every=CPE), ByLenModel(),
                       device="cpu")
    port.run_trace(_cut(trace, 0, 900))
    bufs = port._bufs
    ptrs = {k: t.data_ptr() for k, t in bufs["state"].items()}
    kept = {k: v.clone() for k, v in port.state.items()}
    held = port.state
    assert all(held[k].data_ptr() != ptrs[k] for k in ptrs)
    port.run_trace(_cut(trace, 900, LIMIT))
    assert port._bufs is bufs
    assert {k: t.data_ptr() for k, t in bufs["state"].items()} == ptrs
    for k, v in kept.items():
        assert torch.equal(held[k], v), k


def test_step_backend_knob():
    """"eager" is the CPU's default; "graph" needs CUDA; an unknown name
    raises."""
    assert FenixSystem(FenixConfig(), ByLenModel(),
                       device="cpu").step_backend == "eager"
    with pytest.raises(ValueError, match="CUDA"):
        FenixSystem(FenixConfig(step_backend="graph"), ByLenModel(),
                    device="cpu")
    with pytest.raises(ValueError, match="unknown step_backend"):
        FenixConfig(step_backend="compile")


def test_graph_warm_up_copies_only_the_scratch_paths():
    """The warm-up before capture writes copies at the scratch key paths
    and the step's own buffers elsewhere; the caller's dicts stay as they
    were."""
    from repro_torch import _graph

    pos = torch.zeros((), dtype=torch.int32)
    bufs = {"state": {"a": torch.zeros(2)}, "out": torch.zeros(1),
            "cache": {"k": torch.zeros(3), "pos": pos}}
    w = _graph.with_scratch(bufs, [("state",), ("cache", "pos")])
    w["state"]["a"] += 1
    w["cache"]["pos"] += 1
    w["cache"]["k"] += 1
    assert float(bufs["state"]["a"].sum()) == 0 and int(pos) == 0
    assert bufs["cache"]["pos"] is pos
    assert w["cache"]["k"] is bufs["cache"]["k"] and w["out"] is bufs["out"]
    assert float(bufs["cache"]["k"].sum()) == 3


def test_graph_refuses_to_replay_once_what_it_reads_moved():
    """A captured step's reads outside its buffers (a module's buffers, a
    tree's arrays) are held at capture; once one of them moves the graph
    is stale and its replay raises."""
    from repro_torch import _graph

    model = torch.nn.Module()
    model.register_buffer("w", torch.ones(3))
    tree = {"feat": torch.zeros(4, dtype=torch.int32), "depth": 4}
    graph = _graph.Graph(None, {}, 0.0,
                         lambda: _graph.tensors_of(model, tree))
    assert len(graph._held) == 2 and not graph.stale()
    model.to("cpu")                       # no move: the same tensors
    assert not graph.stale()
    model.to(torch.float64)
    assert graph.stale()
    with pytest.raises(RuntimeError, match="moved after capture"):
        graph.replay()
    graph = _graph.Graph(None, {}, 0.0,
                         lambda: _graph.tensors_of(model, tree))
    tree["feat"] = tree["feat"].clone()
    assert graph.stale()
