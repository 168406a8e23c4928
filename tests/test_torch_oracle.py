"""Oracle payloads in the port: ``synthetic_traffic``'s copy (oracle
payloads, the uniform load generator, class weights, the by-flow split)
equal to the reference's, and ``FenixSystem(oracle_windows=)`` on the
device and host drivers (with the switch tree, a ragged tail and two
run_trace calls in a row) bit-identical to the reference's, for
int8_cnn_tiny and int8_rnn_tiny.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.configs.fenix_models import (fenix_cnn_tiny,  # noqa: E402
                                        fenix_rnn_tiny)
from repro.core.data_engine.decision_tree import (  # noqa: E402
    fit_tree as j_fit_tree, tree_arrays as j_tree_arrays)
from repro.core.fenix import FenixConfig as JFenixConfig  # noqa: E402
from repro.core.fenix import FenixSystem as JFenixSystem  # noqa: E402
from repro.core.model_engine.inference import (  # noqa: E402
    EngineModel as JEngineModel)
from repro.data import synthetic_traffic as jst  # noqa: E402
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant.quantize import quantize_traffic  # noqa: E402
from repro_torch.configs import fenix_models as tfm  # noqa: E402
from repro_torch.core.data_engine.decision_tree import (  # noqa: E402
    tree_arrays)
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine.inference import EngineModel  # noqa: E402
from repro_torch.core.model_engine.serving import (  # noqa: E402
    qparams_from_numpy)
from repro_torch.data import synthetic_traffic as tst  # noqa: E402

# 1800 packets in batches of 256: seven chunks (two T_w windows of
# three) and a ragged tail of eight
BATCH, CPE, LIMIT = 256, 3, 1800
TABLE_KEYS = ("lut", "bucket", "t_last", "hash", "cls", "ring", "rng_key",
              "flow_cnt", "win_pkt_cnt", "win_start", "granted")
MODELS = {"int8_cnn_tiny": (fenix_cnn_tiny, tfm.fenix_cnn_tiny),
          "int8_rnn_tiny": (fenix_rnn_tiny, tfm.fenix_rnn_tiny)}


@pytest.fixture(scope="module")
def flows():
    return jst.make_flows("iscx", 50, seed=11)


@pytest.fixture(scope="module")
def trace(flows):
    return jst.packet_stream(flows, limit=LIMIT)


@pytest.fixture(scope="module")
def oracle(flows):
    return [np.stack([f.pkt_len, f.ipd_us], -1).astype(np.int32)
            for f in flows]


@pytest.fixture(scope="module")
def tree(flows):
    x, y, _ = jst.windows_from_flows(flows)
    return j_fit_tree(x[:, -1, :], y, depth=4, num_classes=7)


_models = {}


def _model_pair(name, flows):
    if name not in _models:
        jf, tf_ = MODELS[name]
        x, _, _ = jst.windows_from_flows(flows)
        qp = quantize_traffic(jtraffic.init(jf(), seed=0), jf(),
                              jnp.asarray(x[:128]))
        _models[name] = (JEngineModel(jf(), qp), EngineModel(
            tf_(), qparams_from_numpy(jax.tree.map(np.asarray, qp), "cpu")))
    return _models[name]


def test_oracle_payloads_match_reference(trace, oracle):
    """Every packet's ground-truth ring window, [n, 9, 2] int32, and the
    per-packet ring_window it vectorises."""
    ref = jst.oracle_payloads(oracle, trace["flow_idx"], trace["flow_pos"],
                              9)
    port = tst.oracle_payloads(oracle, trace["flow_idx"],
                               trace["flow_pos"], 9)
    assert port.dtype == ref.dtype == np.int32 and port.shape == (LIMIT, 9,
                                                                  2)
    assert np.array_equal(port, ref)
    for i in (0, 17, LIMIT - 1):
        assert np.array_equal(port[i], tst.ring_window(
            oracle[trace["flow_idx"][i]], trace["flow_pos"][i], 9))


def test_uniform_flow_stream_matches_reference():
    ref = jst.uniform_flow_stream(5000, 97, seed=3, gap_us=7)
    port = tst.uniform_flow_stream(5000, 97, seed=3, gap_us=7)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        assert np.array_equal(port[k], ref[k]), k


def test_class_weights_and_split_match_reference(flows):
    x, y, f = jst.windows_from_flows(flows)
    assert np.array_equal(tst.class_weights(y, 7), jst.class_weights(y, 7))
    for seed in (0, 5):
        ref = jst.train_test_split(x, y, f, test_frac=0.3, seed=seed)
        port = tst.train_test_split(x, y, f, test_frac=0.3, seed=seed)
        for a, b in zip(ref, port):
            for r, p in zip(a, b):
                assert r.dtype == p.dtype and np.array_equal(r, p)


def _systems(name, flows, oracle, tree, driver):
    jmodel, tmodel = _model_pair(name, flows)
    ref = JFenixSystem(JFenixConfig(batch_size=BATCH,
                                    control_plane_every=CPE, driver=driver),
                       jmodel, tree=j_tree_arrays(tree),
                       oracle_windows=oracle)
    port = FenixSystem(FenixConfig(batch_size=BATCH, control_plane_every=CPE,
                                   driver=driver), tmodel,
                       tree=tree_arrays(tree, "cpu"), device="cpu",
                       oracle_windows=oracle)
    return ref, port


def _same(ref, port, where):
    assert port.stats == ref.stats, where
    for k in TABLE_KEYS:
        assert_same(ref.state[k], port.state[k], f"{where} {k}")


@pytest.mark.parametrize("driver", ["device", "host"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_oracle_replay_matches_reference(flows, trace, oracle, tree, name,
                                         driver):
    """Oracle payloads with the switch tree: verdicts, stats and tables
    bit-identical to the reference's same driver, ragged tail included."""
    ref, port = _systems(name, flows, oracle, tree, driver)
    v_ref = np.asarray(ref.run_trace(dict(trace))["verdict"])
    v = port.run_trace(dict(trace))["verdict"]
    assert np.array_equal(v, v_ref)
    _same(ref, port, f"{name} {driver}")
    if driver == "device":
        assert_same(dict(ref.queues), dict(port.queues), "queues")
        assert_same(dict(ref._dl), dict(port._dl), "delay line")
    assert ref.stats["inferences"] > 0 and ref.stats["tree_pkts"] > 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_oracle_payloads_change_the_verdicts(flows, trace, oracle, tree,
                                             name):
    """The oracle's windows are what the Model Engine serves: the same
    trace without them (the flow table's rings) classifies otherwise."""
    _, port = _systems(name, flows, oracle, tree, "device")
    _, ring = _systems(name, flows, None, tree, "device")
    v = port.run_trace(dict(trace))["verdict"]
    assert not np.array_equal(v, ring.run_trace(dict(trace))["verdict"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_oracle_two_run_traces_in_a_row_match_reference(flows, trace,
                                                        oracle, tree, name):
    """Two replays on one system, each with a ragged tail, then a stream
    without ``flow_idx`` (the ring's payloads, as in the reference)."""
    ref, port = _systems(name, flows, oracle, tree, "device")
    cuts = ((0, 1000), (1000, LIMIT))
    for lo, hi in cuts:
        part = {k: v[lo:hi] for k, v in trace.items()}
        v_ref = np.asarray(ref.run_trace(part)["verdict"])
        assert np.array_equal(port.run_trace(part)["verdict"], v_ref)
        _same(ref, port, f"{name} [{lo}, {hi})")
    bare = {k: v for k, v in trace.items() if k != "flow_idx"}
    v_ref = np.asarray(ref.run_trace(bare)["verdict"])
    assert np.array_equal(port.run_trace(bare)["verdict"], v_ref)
    _same(ref, port, f"{name} without flow_idx")
