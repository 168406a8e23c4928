"""The port's host driver (fast and ``exact=True``) replays the
conformance trace bit-identically to the reference's ``driver="host"``
— verdicts, the stats dict, ``host_syncs`` and the final tables — for
ByLenModel and int8_cnn_tiny, with and without the switch decision
tree; the port's device driver with a tree matches the reference's; and
``run_trace`` followed by ``step`` (and back) hands in-flight results
across as the reference does."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.configs.fenix_models import fenix_cnn_tiny  # noqa: E402
from repro.core.data_engine.decision_tree import (  # noqa: E402
    fit_tree as j_fit_tree, tree_arrays as j_tree_arrays)
from repro.core.fenix import FenixConfig as JFenixConfig  # noqa: E402
from repro.core.fenix import FenixSystem as JFenixSystem  # noqa: E402
from repro.core.model_engine.inference import (  # noqa: E402
    ByLenModel as JByLenModel, EngineModel as JEngineModel)
from repro.data.synthetic_traffic import (make_flows,  # noqa: E402
                                          packet_stream, windows_from_flows)
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant.quantize import quantize_traffic  # noqa: E402
from repro_torch.configs.fenix_models import (  # noqa: E402
    fenix_cnn_tiny as t_fenix_cnn_tiny)
from repro_torch.core.data_engine.decision_tree import (  # noqa: E402
    tree_arrays)
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine.inference import (  # noqa: E402
    ByLenModel, EngineModel)
from repro_torch.core.model_engine.serving import (  # noqa: E402
    qparams_from_numpy)

# the conformance trace of tests/test_torch_fenix.py
TRACE_FLOWS, TRACE_SEED, TRACE_LIMIT = 40, 7, 1800
BATCH, CPE = 256, 3
# every table of the state dict; the exact scan also keeps the
# per-packet counters (pkt_cnt, collisions, denied_*)
TABLE_KEYS = ("lut", "bucket", "t_last", "hash", "cls", "bklog_n",
              "bklog_t", "buff_idx", "last_ts", "ring", "rng_key",
              "flow_cnt", "win_pkt_cnt", "win_start", "granted", "pkt_cnt",
              "collisions", "denied_prob", "denied_tokens")


@pytest.fixture(scope="module")
def flows():
    return make_flows("iscx", TRACE_FLOWS, seed=TRACE_SEED)


@pytest.fixture(scope="module")
def trace(flows):
    return packet_stream(flows, limit=TRACE_LIMIT)


@pytest.fixture(scope="module")
def tree(flows):
    """A depth-4 switch tree fit on the trace's flows' F9 features, as
    the reference's tests fit it."""
    x, y, _ = windows_from_flows(flows)
    return j_fit_tree(x[:, -1, :], y, depth=4, num_classes=7)


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


def _pair(models, tree, driver, exact=False):
    """(reference system, port system) on the same config, models and
    tree."""
    jmodel, tmodel = models
    ref = JFenixSystem(JFenixConfig(batch_size=BATCH,
                                    control_plane_every=CPE, driver=driver,
                                    exact=exact), jmodel,
                       tree=None if tree is None else j_tree_arrays(tree))
    port = FenixSystem(FenixConfig(batch_size=BATCH,
                                   control_plane_every=CPE, driver=driver,
                                   exact=exact), tmodel,
                       tree=None if tree is None else tree_arrays(tree,
                                                                  "cpu"),
                       device="cpu")
    return ref, port


def _models(model_name, tiny_int8):
    return (JByLenModel(), ByLenModel()) if model_name == "bylen" \
        else tiny_int8


def _assert_systems_equal(ref, port, where):
    assert port.stats == ref.stats, where
    assert port.host_syncs == ref.host_syncs, where
    for k in TABLE_KEYS:
        assert_same(ref.state[k], port.state[k], f"{where} {k}")
    assert_same({k: v for k, v in ref.queues.items()},
                dict(port.queues), f"{where} queues")


@pytest.mark.parametrize("with_tree", [False, True])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("model_name", ["bylen", "int8_cnn_tiny"])
def test_host_driver_matches_reference(trace, tree, tiny_int8, model_name,
                                       exact, with_tree):
    ref, port = _pair(_models(model_name, tiny_int8),
                      tree if with_tree else None, "host", exact)
    v_ref = np.asarray(ref.run_trace(dict(trace))["verdict"])
    v = port.run_trace(dict(trace))["verdict"]
    where = f"{model_name} exact={exact} tree={with_tree}"
    assert v.dtype == np.int32 and v.shape == (TRACE_LIMIT,)
    assert np.array_equal(v, v_ref), where
    _assert_systems_equal(ref, port, where)
    assert ref.host_syncs == TRACE_LIMIT // (BATCH * CPE)
    assert ref.stats["inferences"] > 0 and int((v >= 0).sum()) > 0
    if with_tree and not exact:
        assert ref.stats["tree_pkts"] > 0
    assert port._inflight == ref._inflight, where


@pytest.mark.parametrize("model_name", ["bylen", "int8_cnn_tiny"])
def test_device_driver_with_tree_matches_reference(trace, tree, tiny_int8,
                                                   model_name):
    ref, port = _pair(_models(model_name, tiny_int8), tree, "device")
    v_ref = np.asarray(ref.run_trace(dict(trace))["verdict"])
    v = port.run_trace(dict(trace))["verdict"]
    assert np.array_equal(v, v_ref)
    _assert_systems_equal(ref, port, model_name)
    assert ref.stats["tree_pkts"] > 0 and port.host_syncs == 0
    assert_same({k: v for k, v in ref._dl.items()}, dict(port._dl),
                "delay line")


def _cut(trace, lo, hi):
    return {k: v[lo:hi] for k, v in trace.items()}


@pytest.mark.parametrize("with_tree", [False, True])
def test_run_trace_then_step_interop(trace, tree, with_tree):
    """A device replay, host steps, then a device replay again: the
    in-flight results drain from the delay line into the host list in
    ring order and back, and every verdict, step output and table agrees
    with the reference's."""
    ref, port = _pair(_models("bylen", None),
                      tree if with_tree else None, "device")
    assert np.array_equal(np.asarray(ref.run_trace(_cut(trace, 0, 700))
                                     ["verdict"]),
                          port.run_trace(_cut(trace, 0, 700))["verdict"])
    for lo in (700, 956, 1212):
        r, p = ref.step(_cut(trace, lo, lo + BATCH)), \
            port.step(_cut(trace, lo, lo + BATCH))
        assert sorted(r) == sorted(p)
        for k in r:
            assert np.asarray(r[k]).dtype == p[k].dtype, k
            assert np.array_equal(np.asarray(r[k]), p[k]), (lo, k)
        assert port._inflight == ref._inflight, lo
    assert len(ref._inflight) > 0      # the next replay pushes these
    assert np.array_equal(
        np.asarray(ref.run_trace(_cut(trace, 1468, TRACE_LIMIT))
                   ["verdict"]),
        port.run_trace(_cut(trace, 1468, TRACE_LIMIT))["verdict"])
    _assert_systems_equal(ref, port, f"tree={with_tree}")
