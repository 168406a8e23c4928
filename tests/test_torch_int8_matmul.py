"""The port's INT8 GEMM surface is bit-identical to the reference:
int8_matmul / int8_conv1d against JAX's "ref" and interpreted "pallas"
backends, bucketize against traffic.bucketize, and int8_apply logits of a
model carried across by qparams_from_numpy; on a card, the Hopper kernel
against its plain version."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.configs.fenix_models import fenix_cnn_tiny  # noqa: E402
from repro.data.synthetic_traffic import (make_flows,  # noqa: E402
                                          windows_from_flows)
from repro.kernels.int8_matmul import ops as jops  # noqa: E402
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant.quantize import int8_apply as j_int8_apply  # noqa: E402
from repro.quant.quantize import quantize_traffic  # noqa: E402
from repro_torch.configs.fenix_models import (  # noqa: E402
    fenix_cnn_tiny as t_fenix_cnn_tiny)
from repro_torch.core.model_engine.serving import (  # noqa: E402
    qparams_from_numpy)
from repro_torch.kernels.int8_matmul import ops  # noqa: E402
from repro_torch.kernels.int8_matmul.kernel import int8_gemm  # noqa: E402
from repro_torch.models import traffic  # noqa: E402
from repro_torch.quant.quantize import int8_apply  # noqa: E402

SHAPES = [(1, 1, 1), (5, 33, 7), (37, 96, 19), (130, 70, 129)]
SHIFTS = [None, 0, 1, 9]


def _operands(rng, m, k, n):
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    bias = rng.integers(-40_000, 40_000, n).astype(np.int32)
    return a, b, bias


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
def test_int8_matmul_matches_jax(shape, jax_backend):
    rng = np.random.default_rng(sum(shape))
    a, b, bias = _operands(rng, *shape)
    for shift in SHIFTS:
        for use_bias in (False, True):
            bj = jnp.asarray(bias) if use_bias else None
            bt = torch.from_numpy(bias) if use_bias else None
            ref = jops.int8_matmul(jnp.asarray(a), jnp.asarray(b), bj,
                                   shift, backend=jax_backend)
            port = ops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                   bt, shift)
            assert port.dtype == (torch.int32 if shift is None
                                  else torch.int8)
            assert_same(ref, port, f"{shape} shift={shift} bias={use_bias}")


@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
def test_int8_conv1d_matches_jax(jax_backend):
    rng = np.random.default_rng(3)
    for bsz, s, cin, kk, cout in [(3, 9, 8, 3, 5), (2, 9, 32, 3, 64),
                                  (4, 5, 3, 5, 2)]:
        x = rng.integers(-128, 128, (bsz, s, cin)).astype(np.int8)
        w = rng.integers(-128, 128, (kk, cin, cout)).astype(np.int8)
        bias = rng.integers(-3000, 3000, cout).astype(np.int32)
        for shift in (None, 7):
            ref = jops.int8_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(bias), shift,
                                   backend=jax_backend)
            port = ops.int8_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(bias), shift)
            assert_same(ref, port, f"conv {x.shape} {w.shape} {shift}")


def test_cuda_backend_rejects_cpu_tensors():
    a, b, bias = _operands(np.random.default_rng(0), 4, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b),
                        backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        int8_gemm(torch.from_numpy(a), torch.from_numpy(b))


def _sweep_ipds():
    ks = np.arange(1, 32, dtype=np.int64)
    edges = np.concatenate([(1 << ks) - 1, 1 << ks, (1 << ks) + 1])
    edges = edges[edges < 2**31]
    return np.concatenate([np.arange(0, (1 << 20) + 1, dtype=np.int64),
                           edges, [-5, -1, 2**31 - 1]]).astype(np.int32)


def test_bucketize_matches_jax_sweep():
    """Every ipd up to 2^20 and 2^k-1, 2^k, 2^k+1 up to 2^31."""
    cfg, tcfg = fenix_cnn_tiny(), t_fenix_cnn_tiny()
    ipd = _sweep_ipds()
    rng = np.random.default_rng(0)
    payload = np.stack([rng.integers(-100, 3000, ipd.shape[0]).astype(
        np.int32), ipd], axis=-1)[:, None, :]
    ref = jtraffic.bucketize(jnp.asarray(payload), cfg)
    assert_same(ref, traffic.bucketize(torch.from_numpy(payload), tcfg))


def test_ipd_log2_table_rederived_from_jax():
    """The port's table of inputs where the reference's float32
    floor(log2) is not the exponent: every integer float32 within 2^-9
    (relative) of a power of two, plus every integer up to 2^20."""
    vals = [np.arange(1, (1 << 20) + 2, dtype=np.float64)]
    for k in range(19, 32):
        lo = np.float32(2.0**k * (1 - 2**-9)).view(np.int32)
        hi = np.float32(2.0**k * (1 + 2**-9)).view(np.int32)
        vals.append(np.arange(lo, hi + 1, dtype=np.int32).view(np.float32)
                    .astype(np.float64))
    f = np.unique(np.concatenate(vals)).astype(np.float32)
    f = f[(f >= 1) & (f <= np.float32(2.0**31)) & (np.floor(f) == f)]
    lg = np.asarray(jnp.floor(jnp.log2(jnp.asarray(f))).astype(jnp.int32))
    exact = np.frexp(f.astype(np.float64))[1] - 1
    bad = lg != exact
    keys, v = traffic.ipd_log2_table()
    assert_same(np.sort(f[bad].view(np.int32)), keys)
    assert_same(lg[bad][np.argsort(f[bad].view(np.int32))], v)


def test_int8_apply_logits_match_jax():
    """int8_cnn_tiny with weights carried across: traffic.init +
    quantize_traffic in JAX, qparams_from_numpy into the port."""
    cfg = fenix_cnn_tiny()
    x, _, _ = windows_from_flows(make_flows("iscx", 60, seed=3))
    qp = quantize_traffic(jtraffic.init(cfg, seed=0), cfg,
                          jnp.asarray(x[:256]))
    qp_t = qparams_from_numpy(jax.tree.map(np.asarray, qp), "cpu")
    ref = j_int8_apply(qp, cfg, jnp.asarray(x[:400]))
    port = int8_apply(qp_t, t_fenix_cnn_tiny(), torch.from_numpy(x[:400]))
    assert port.dtype == torch.int32
    assert_same(ref, port)
    assert int(np.unique(np.argmax(np.asarray(ref), -1)).size) > 1


def test_qparams_hold_gemm_weights_k_major():
    """qparams_from_numpy gives the reference's arrays, each GEMM weight a
    view of a K-major buffer: a conv weight's [kk*Cin, Cout] reshape is a
    view (same storage, stride(0) == 1) and the FC and head weights have
    stride(0) == 1; int8_apply on them equals JAX (above) and so does a
    FenixSystem replay (tests/test_torch_fenix.py)."""
    cfg = fenix_cnn_tiny()
    x, _, _ = windows_from_flows(make_flows("iscx", 60, seed=3))
    qp = jax.tree.map(np.asarray, quantize_traffic(
        jtraffic.init(cfg, seed=0), cfg, jnp.asarray(x[:256])))
    port = qparams_from_numpy(qp, "cpu")
    gemm = [k for k in qp if k.endswith("/w")]
    assert sorted(gemm) == sorted(
        [f"conv{i}/w" for i in range(len(cfg.conv_filters))]
        + [f"fc{i}/w" for i in range(len(cfg.fc_dims))] + ["head/w"])
    for key in gemm:
        w = port[key]
        assert_same(qp[key], w, key)
        if w.dim() == 3:
            kk, cin, cout = w.shape
            w2 = w.reshape(kk * cin, cout)
            assert w2.data_ptr() == w.data_ptr(), key
            assert w2.stride(0) == 1, key
        else:
            assert w.stride(0) == 1, key
    for key in qp:
        if key not in gemm and isinstance(port[key], torch.Tensor):
            assert port[key].is_contiguous(), key
    assert ops.k_major(torch.from_numpy(qp["fc0/w"].copy())).stride(0) == 1


# the serving path's six GEMMs at full width (chip_smoke.PATH_GEMMS) and
# ragged ones (the tiny model's K = 24, 8, 16; M = 1; odd N)
_TILE_SHAPES = [(9216, 96, 64), (9216, 192, 128), (9216, 384, 256),
                (1024, 256, 512), (1024, 512, 256), (1024, 256, 7),
                (2304, 24, 16), (300, 8, 7), (1024, 16, 7), (1, 96, 64),
                (1, 1, 1), (17, 33, 9), (77, 512, 300)]


@pytest.mark.parametrize("shape", _TILE_SHAPES)
def test_gemm_tile_and_copy_width_are_legal(shape):
    """The tile chooser returns a tile of the kernel (an index into
    TILES) no wider than twice N unless it is the narrowest; the copy
    width divides K, the leading dimensions and the pointers."""
    from repro_torch.kernels.int8_matmul.kernel import (TILES, copy_width,
                                                        gemm_tile)

    m, k, n = shape
    for sms in (132, 114, 1):
        i = gemm_tile(m, n, sms)
        assert 0 <= i < len(TILES)
        bn = TILES[i][1]
        assert bn < 2 * n or bn == min(t[1] for t in TILES)
    w = copy_width(k, k, k, 256, 512)
    assert w in (16, 4, 1) and k % w == 0
    assert copy_width(k, k, k, 256, 513) == 1
    if m * n >= 132 * 2 * 32 * 32:
        bm, bn = TILES[gemm_tile(m, n, 132)]
        assert -(-m // bm) * -(-n // bn) >= 2 * 132
