"""The port's post-training quantizer and serving factory against the
reference on the CPU: ``quantize_traffic`` bit-identical given the same
float params, ``train_quantized`` within 0.05 macro-F1 of the
reference's on the same eval windows, quantized checkpoints readable
both ways, ``evaluate_quantized`` and the baselines' metrics, and the
default trained model served by ``build_model`` / ``FenixSystem``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.baselines import common as jcommon  # noqa: E402
from repro.configs import fenix_models as jcfgs  # noqa: E402
from repro.core.model_engine import serving as jserving  # noqa: E402
from repro.data.synthetic_traffic import (make_flows,  # noqa: E402
                                          windows_from_flows)
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant import quantize as jquant  # noqa: E402
from repro_torch.baselines import common as tcommon  # noqa: E402
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine import serving as tserving  # noqa: E402
from repro_torch.core.model_engine.inference import (  # noqa: E402
    EngineModel)
from repro_torch.data import synthetic_traffic as ttraffic_data  # noqa: E402
from repro_torch.quant import quantize as tquant  # noqa: E402

MODELS = ["int8_cnn_tiny", "int8_rnn_tiny"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same_layout(ref, port):
    """Equal keys, values and dtypes, nested dicts included."""
    assert sorted(ref) == sorted(port)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_same_layout(v, port[k])
            continue
        assert port[k].dtype == v.dtype, (k, port[k].dtype, v.dtype)
        assert_same(v, port[k], k)


@pytest.fixture(scope="module")
def corpus():
    """synthetic_corpus(n_flows=160, seed=5) on both sides (pcap written
    and ingested back by each package), as tests/test_quantize.py."""
    jflows = jserving.synthetic_corpus(n_flows=160, seed=5)
    tflows = tserving.synthetic_corpus(n_flows=160, seed=5)
    x, y, _ = windows_from_flows(jflows, seed=99)
    return jflows, tflows, x[:512], y[:512]


@pytest.fixture(scope="module")
def trained(corpus):
    """train_quantized, 600 steps, on both sides, per model name."""
    jflows, tflows, _, _ = corpus
    out = {}
    for name in MODELS:
        jc = jserving.model_config(name)
        tc = tserving.model_config(name)
        out[name] = (jc, tc,
                     jserving.train_quantized(jc, jflows, steps=600, seed=5),
                     tserving.train_quantized(tc, tflows, steps=600, seed=5,
                                              device="cpu"))
    return out


def test_synthetic_corpus_matches_reference(corpus):
    jflows, tflows, _, _ = corpus
    assert len(jflows) == len(tflows)
    for a, b in zip(jflows, tflows):
        assert a.label == b.label and a.five_tuple == b.five_tuple
        assert np.array_equal(a.pkt_len, b.pkt_len)
        assert np.array_equal(a.ipd_us, b.ipd_us)


@pytest.mark.parametrize("shift", [-3, 0, 5, 12])
def test_quantize_array_matches_reference(shift):
    rng = np.random.default_rng(shift + 10)
    x = rng.normal(0, 2.0 ** -shift * 60, 257)
    for dtype in (np.int8, np.int32):
        assert_same(jquant.quantize_array(x, shift, dtype),
                    tquant.quantize_array(x, shift, dtype))
    q = tquant.quantize_array(x, shift)
    assert np.array_equal(jquant.dequantize_array(q, shift),
                          tquant.dequantize_array(q, shift))
    for absmax in (1e-9, 0.3, 1.0, 127.0, 5e3):
        assert jquant._shift_for(absmax) == tquant._shift_for(absmax)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_traffic_bit_identical_on_init_params(name, seed):
    """Given the same float params (the reference's init, carried across
    as numpy) and calibration windows, the integer model is bit for bit
    the reference's: keys, values and dtypes."""
    jc = getattr(jcfgs, name.replace("int8_", "fenix_"))()
    tc = tserving.model_config(name)
    x, _, _ = windows_from_flows(make_flows("iscx", 40, seed=seed),
                                 seed=seed)
    params = jtraffic.init(jc, seed)
    ref = _np_tree(jquant.quantize_traffic(params, jc,
                                           jnp.asarray(x[:256])))
    port = tquant.quantize_traffic(_np_tree(params), tc, x[:256])
    _assert_same_layout(ref, port)


@pytest.mark.parametrize("name", MODELS)
def test_quantize_traffic_bit_identical_on_trained_params(name, trained,
                                                          corpus):
    """The reference's trained params, carried across as numpy (as
    tensors too), quantize to the reference's integer model, on three
    calibration sets."""
    jc, tc, (jparams, jqp, _), _ = trained[name]
    jflows = corpus[0]
    for seed in (5, 6, 7):
        x, _, _ = windows_from_flows(jflows, seed=seed)
        ref = _np_tree(jquant.quantize_traffic(jparams, jc,
                                               jnp.asarray(x[:512])))
        host = _np_tree(jparams)
        _assert_same_layout(ref, tquant.quantize_traffic(host, tc,
                                                         x[:512]))
        as_tensors = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
        _assert_same_layout(ref, tquant.quantize_traffic(as_tensors, tc,
                                                         x[:512]))
    _assert_same_layout(_np_tree(jqp), tquant.quantize_traffic(
        _np_tree(jparams), tc, windows_from_flows(jflows, seed=5)[0][:512]))


@pytest.mark.parametrize("name", MODELS)
def test_train_quantized_macro_f1_within_005_of_reference(name, trained,
                                                          corpus):
    """train_quantized on the same corpus, 600 steps: the port's integer
    model reaches the reference's macro-F1 on the same eval windows
    within 0.05 (the reference's own int8-vs-float bar; measured here:
    equal to 1e-12, with identical predictions)."""
    jc, tc, (_, jqp, jm), (tparams, tqp, tm) = trained[name]
    _, _, x, y = corpus
    ref = jserving.evaluate_quantized(jqp, jc, x, y)
    port = tserving.evaluate_quantized(tqp, tc, x, y, device="cpu")
    assert abs(port["macro_f1"] - ref["macro_f1"]) <= 0.05
    assert port["macro_f1"] > 0.5               # the model learned
    assert port["pred"].dtype == np.int32
    assert sorted(tm) == sorted(jm)
    assert all(v.device.type == "cpu" for v in tparams.values())


@pytest.mark.parametrize("name", MODELS)
def test_evaluate_quantized_matches_reference(name, trained, corpus):
    """On the same integer model the port's evaluation equals the
    reference's: predictions, macro-F1 and confusion."""
    jc, tc, (_, jqp, _), _ = trained[name]
    _, _, x, y = corpus
    ref = jserving.evaluate_quantized(jqp, jc, x, y)
    port = tserving.evaluate_quantized(_np_tree(jqp), tc, x, y,
                                       backend="ref", device="cpu")
    assert np.array_equal(np.asarray(ref["pred"]), port["pred"])
    assert port["macro_f1"] == ref["macro_f1"]
    assert port["confusion"] == ref["confusion"]
    with pytest.raises(ValueError, match="CUDA"):
        tserving.evaluate_quantized(_np_tree(jqp), tc, x, y,
                                    backend="cuda", device="cpu")


def test_quantized_checkpoints_are_readable_both_ways(tmp_path, trained):
    """The port's save_quantized serves through the reference's
    load_quantized and the reference's through the port's."""
    jc, tc, (_, jqp, _), (_, tqp, _) = trained["int8_rnn_tiny"]
    tserving.save_quantized(tmp_path / "port", tqp, tc, meta={"by": "port"})
    qp, cfg = jserving.load_quantized(str(tmp_path / "port"))
    assert cfg == jc
    _assert_same_layout(tqp, _np_tree(qp))
    jserving.save_quantized(str(tmp_path / "ref"), jqp, jc)
    qp, cfg = tserving.load_quantized(tmp_path / "ref")
    assert cfg == tc
    _assert_same_layout(_np_tree(jqp), qp)
    model = tserving.build_model("int8_rnn_tiny", model_dir=tmp_path / "ref",
                                 device="cpu")
    assert isinstance(model, EngineModel) and model.cfg == tc


def test_baseline_metrics_match_reference():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 5, 300)
    p = np.where(rng.random(300) < 0.7, y, rng.integers(0, 5, 300))
    f = rng.integers(0, 40, 300)
    assert tcommon.macro_f1(y, p, 5) == jcommon.macro_f1(y, p, 5)
    assert tcommon.per_class_prf(y, p, 5) == jcommon.per_class_prf(y, p, 5)
    assert_same(jcommon.confusion_matrix(y, p, 5),
                tcommon.confusion_matrix(y, p, 5))
    for a, b in zip(jcommon.flow_vote(p, f), tcommon.flow_vote(p, f)):
        assert_same(a, b)
    jflows = make_flows("ustc", 30, seed=2)
    tflows = ttraffic_data.make_flows("ustc", 30, seed=2)
    for a, b in zip(jcommon.flow_feature_matrix(jflows),
                    tcommon.flow_feature_matrix(tflows)):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_default_model_trains_and_serves_on_the_cpu():
    """FenixConfig(model="int8_cnn_tiny") with no model_dir trains the
    default instance on the synthetic corpus (once per process and device
    type) and serves it."""
    sys_ = FenixSystem(FenixConfig(model="int8_cnn_tiny", batch_size=256),
                       device="cpu")
    assert isinstance(sys_.model, EngineModel)
    assert sys_.model.q_conv0__w.device.type == "cpu"
    again = tserving.build_model("int8_cnn_tiny", device="cpu")
    assert_same(dict(sys_.model.named_buffers()),
                dict(again.named_buffers()))
    stream = ttraffic_data.packet_stream(
        ttraffic_data.make_flows("iscx", 30, seed=4), limit=1500)
    out = sys_.run_trace(stream)
    v = out["verdict"]
    assert v.shape == (1500,) and v.min() >= -1 and v.max() < 7
    assert sys_.stats["inferences"] > 0


def test_build_model_without_device_raises_without_cuda(monkeypatch,
                                                        tmp_path, trained):
    """Entry points default to the card: with no device and no CUDA,
    build_model (from a checkpoint or training the default),
    train_quantized and evaluate_quantized raise."""
    jc, tc, _, (_, tqp, _) = trained["int8_cnn_tiny"]
    tserving.save_quantized(tmp_path, tqp, tc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.build_model("int8_cnn_tiny", model_dir=tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.build_model("int8_rnn_tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.train_quantized(tc, [], steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.evaluate_quantized(tqp, tc, np.zeros((1, 9, 2), np.int32),
                                    np.zeros(1, np.int32))
