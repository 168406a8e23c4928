"""The FENIX-RNN (the paper's second model, §7.1) in the port: the
``rnn`` branch of ``int8_apply`` bit-identical to the reference's, for
``fenix_rnn_tiny`` and the full-width ``fenix_rnn``, against the
reference's "ref" and interpreted "pallas" GEMMs and with hand-set
shifts (a ``lut_preshift`` of 0 and -1, where ``>>`` by a negative count
sign-fills, and ``shift_x`` = 0); its weights carried across K-major
and read from a reference checkpoint; and FenixSystem replays serving
it, on the device and host drivers, with a binding token bucket.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.configs.fenix_models import fenix_rnn, fenix_rnn_tiny  # noqa: E402
from repro.core.fenix import FenixConfig as JFenixConfig  # noqa: E402
from repro.core.fenix import FenixSystem as JFenixSystem  # noqa: E402
from repro.core.model_engine import serving as jserving  # noqa: E402
from repro.core.model_engine.inference import (  # noqa: E402
    EngineModel as JEngineModel)
from repro.data.synthetic_traffic import (make_flows,  # noqa: E402
                                          packet_stream, windows_from_flows)
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant.quantize import int8_apply as j_int8_apply  # noqa: E402
from repro.quant.quantize import quantize_traffic  # noqa: E402
from repro_torch.configs import fenix_models as tfm  # noqa: E402
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine import serving  # noqa: E402
from repro_torch.core.model_engine.inference import EngineModel  # noqa: E402
from repro_torch.quant.quantize import int8_apply  # noqa: E402

CONFIGS = {"tiny": (fenix_rnn_tiny, tfm.fenix_rnn_tiny),
           "full": (fenix_rnn, tfm.fenix_rnn)}
N_WIN = 300


@pytest.fixture(scope="module")
def windows():
    x, _, _ = windows_from_flows(make_flows("iscx", 60, seed=3))
    return x


_qp_cache = {}


def _qparams(size, windows):
    """Reference init + quantize_traffic, calibrated on the flows'
    windows (untrained: bit identity is what is at stake), as numpy."""
    if size not in _qp_cache:
        cfg = CONFIGS[size][0]()
        qp = quantize_traffic(jtraffic.init(cfg, seed=0), cfg,
                              jnp.asarray(windows[:256]))
        _qp_cache[size] = jax.tree.map(np.asarray, qp)
    return _qp_cache[size]


def _both(qn, size, payload, jax_backend="ref"):
    jcfg, tcfg = (f() for f in CONFIGS[size])
    ref = np.asarray(j_int8_apply(jax.tree.map(jnp.asarray, qn), jcfg,
                                  jnp.asarray(payload), backend=jax_backend))
    port = int8_apply(serving.qparams_from_numpy(qn, "cpu"), tcfg,
                      torch.from_numpy(payload))
    return ref, port


@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_int8_apply_rnn_matches_reference(windows, size, jax_backend):
    """Logits [N, 7] int32, bit for bit: 2 x 9 + 1 GEMMs, the shifts and
    the tanh-LUT gather of every step."""
    qn = _qparams(size, windows)
    ref, port = _both(qn, size, windows[:N_WIN], jax_backend)
    assert port.dtype == torch.int32 and port.shape == (N_WIN, 7)
    assert_same(ref, port, f"{size} {jax_backend}")
    assert len(np.unique(ref.argmax(-1))) > 1


# (key, value): a lut_preshift of 0 (no shift before the LUT) and of -1
# (a negative count: x >> -1 is -1 for x < 0 and 0 otherwise, in XLA and
# in PyTorch alike), and an input GEMM that is not shifted at all
@pytest.mark.parametrize("key,value", [("cell/lut_preshift", 0),
                                       ("cell/lut_preshift", -1),
                                       ("cell/shift_x", 0)])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_int8_apply_rnn_hand_set_shifts_match_reference(windows, size, key,
                                                        value):
    qn = dict(_qparams(size, windows))
    assert int(qn[key]) != value
    qn[key] = np.asarray(value, np.int32)
    ref, port = _both(qn, size, windows[:N_WIN])
    assert_same(ref, port, f"{size} {key}={value}")


def test_negative_shift_count_sign_fills_as_in_the_reference():
    x = np.array([-5, -1, 0, 3, 2**31 - 1, -2**31], np.int32)
    for count in (0, -1, -3):
        assert_same(np.asarray(jnp.asarray(x) >> count),
                    torch.from_numpy(x) >> count, f">> {count}")
    assert (torch.from_numpy(x) >> -1).tolist() == [-1, -1, 0, 0, 0, -1]


def test_rnn_weights_carried_across_k_major(windows):
    """The cell's two GEMM weights are held K-major (the kernel's B), the
    bias and the tanh LUT as tensors, the shifts as Python ints."""
    qn = _qparams("full", windows)
    qp = serving.qparams_from_numpy(qn, "cpu")
    for k in ("cell/wx", "cell/wh", "head/w"):
        assert qp[k].dtype == torch.int8 and qp[k].stride(0) == 1, k
        assert np.array_equal(qp[k].numpy(), qn[k]), k
    assert qp["cell/wx"].shape == (32, 128)
    assert qp["cell/wh"].shape == (128, 128)
    assert qp["cell/b"].dtype == torch.int32
    assert qp["tanh_lut"].dtype == torch.int8 and qp["tanh_lut"].shape == (
        512,)
    for k in ("cell/shift_x", "cell/shift_h", "cell/lut_preshift"):
        assert isinstance(qp[k], int) and qp[k] == int(qn[k]), k


def test_load_quantized_reads_an_rnn_checkpoint(tmp_path, windows):
    """A reference save_quantized checkpoint of the RNN loads with numpy
    alone; build_model serves it with the reference's logits."""
    cfg = fenix_rnn_tiny(num_classes=5)
    qp = quantize_traffic(jtraffic.init(cfg, seed=4), cfg,
                          jnp.asarray(windows[:128]))
    jserving.save_quantized(str(tmp_path), qp, cfg)
    qp_np, tcfg = serving.load_quantized(tmp_path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.kind == "rnn" and tcfg.rnn_units == 16
    model = serving.build_model("int8_rnn_tiny", model_dir=tmp_path,
                                device="cpu")
    assert isinstance(model, EngineModel)
    payload = windows[:200]
    ref = np.asarray(JEngineModel(cfg, qp).infer(jnp.asarray(payload)))
    assert_same(ref, model.infer(torch.from_numpy(payload)), "classes")


@pytest.mark.parametrize("driver", ["device", "host"])
def test_rnn_replay_with_binding_bucket_matches_reference(windows, driver):
    """int8_rnn_tiny behind a slow Model Engine: the bucket denies grants
    and the ring fills, on both sides alike."""
    from repro.core.data_engine.state import EngineConfig as JEngineConfig
    from repro.core.model_engine.vector_io import IOConfig as JIOConfig
    from repro_torch.core.data_engine.state import EngineConfig
    from repro_torch.core.model_engine.vector_io import IOConfig

    qn = _qparams("tiny", windows)
    trace = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    ref = JFenixSystem(JFenixConfig(
        engine=JEngineConfig(fpga_hz=2e4), io=JIOConfig(queue_len=64),
        batch_size=200, control_plane_every=2, driver="host"),
        JEngineModel(fenix_rnn_tiny(), jax.tree.map(jnp.asarray, qn)),
        n_est=50, q_est_pps=2e4)
    v_ref = np.asarray(ref.run_trace(dict(trace))["verdict"])
    port = FenixSystem(FenixConfig(
        engine=EngineConfig(fpga_hz=2e4), io=IOConfig(queue_len=64),
        batch_size=200, control_plane_every=2, driver=driver),
        EngineModel(tfm.fenix_rnn_tiny(),
                    serving.qparams_from_numpy(qn, "cpu")),
        device="cpu", n_est=50, q_est_pps=2e4)
    v = port.run_trace(dict(trace))["verdict"]
    assert np.array_equal(v, v_ref)
    assert port.stats == ref.stats
    assert 0 < ref.stats["granted"] < len(v)
    assert ref.stats["inferences"] > 0
    for k in ("lut", "bucket", "hash", "cls", "ring"):
        assert_same(ref.state[k], port.state[k], k)
