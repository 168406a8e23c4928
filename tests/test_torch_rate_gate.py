"""The port's Rate-Limiter gates and LUT rebuild are bit-identical to the
reference: fused_admission (on given draws and on the draws of a
threefry key) against JAX's "ref" and interpreted "pallas" backends,
the selection-only rate_gate (given draws, and seeded draws) against
JAX's interpreted "pallas" backend, and build_lut_torch against
build_lut_jnp.  The kernel backends refuse CPU tensors."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.core.probability import LUTConfig as JLUTConfig  # noqa: E402
from repro.core.probability import build_lut_jnp  # noqa: E402
from repro.kernels.rate_gate.ops import (  # noqa: E402
    fused_admission as j_fused_admission, rate_gate as j_rate_gate)
from repro_torch.core.probability import (LUTConfig,  # noqa: E402
                                          build_lut_torch)
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.rate_gate import ref as gate_ref  # noqa: E402
from repro_torch.kernels.rate_gate.kernel import (  # noqa: E402
    fused_gate, fused_gate_prng, rate_gate_prng)
from repro_torch.kernels.rate_gate.ops import (  # noqa: E402
    GATE_BACKENDS, fused_admission, rate_gate, validate_backend)

COST, CAP = 5, 320


def _case(rng, n, t_last_zero):
    """One batch: random LUT, bucket state and lane values."""
    lut = rng.integers(0, 1 << 16, (64, 32)).astype(np.int32)
    lut[rng.random((64, 32)) < 0.2] = 0
    lut[rng.random((64, 32)) < 0.2] = (1 << 16) - 1
    ts = np.sort(rng.integers(10_000, 10_000 + 40 * n, n)).astype(np.int32)
    return dict(
        t_i=rng.integers(-50, 80_000, n).astype(np.int32),
        c_i=rng.integers(-3, 40, n).astype(np.int32),
        ts=ts, lut=lut,
        bucket=np.int32(rng.integers(0, 2 * CAP)),
        t_last=np.int32(0 if t_last_zero
                        else ts[0] - rng.integers(0, 500)),
        rand16=rng.integers(0, 1 << 16, n).astype(np.int32))


def _jax(c, backend):
    g, b = j_fused_admission(
        jnp.asarray(c["t_i"]), jnp.asarray(c["c_i"]), jnp.asarray(c["ts"]),
        jnp.asarray(c["lut"]), jnp.asarray(c["bucket"]),
        jnp.asarray(c["t_last"]), rand16=jnp.asarray(c["rand16"]),
        cost_us=COST, bucket_cap_us=CAP, backend=backend)
    return g, b


def _port(c, backend=None, device="cpu"):
    t = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in c.items()}
    return fused_admission(t["t_i"], t["c_i"], t["ts"], t["lut"],
                           t["bucket"], t["t_last"], rand16=t["rand16"],
                           cost_us=COST, bucket_cap_us=CAP, backend=backend)


# JAX's interpreted kernel at the small sizes, its "ref" backend at those
# of one whole CTA tile (4096 lanes) and past it (8193, the look-back's
# smallest case on the card)
_FUSED_CASES = [(b, n) for b in ("ref", "pallas") for n in (1, 255, 256, 1000)
                ] + [("ref", 4096), ("ref", 8193)]


@pytest.mark.parametrize("jax_backend,n", _FUSED_CASES,
                         ids=[f"{b}-{n}" for b, n in _FUSED_CASES])
def test_fused_admission_matches_jax(n, jax_backend):
    rng = np.random.default_rng(n)
    for trial in range(6):
        c = _case(rng, n, t_last_zero=trial % 3 == 0)
        g_ref, b_ref = _jax(c, jax_backend)
        g, b = _port(c)
        assert g.dtype == torch.bool and g.shape == (n,)
        assert b.dtype == torch.int32 and b.shape == ()
        assert_same(g_ref, g, f"granted n={n} trial={trial}")
        assert_same(b_ref, b, f"bucket n={n} trial={trial}")


def test_fused_admission_cuda_backend_rejects_cpu_tensors():
    c = _case(np.random.default_rng(0), 8, False)
    with pytest.raises(ValueError, match="CUDA"):
        _port(c, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        t = {k: torch.as_tensor(np.asarray(v)) for k, v in c.items()}
        fused_gate(t["t_i"], t["c_i"], t["ts"], t["rand16"], t["lut"],
                   t["bucket"], t["t_last"], t_shift=10, c_shift=0,
                   cost_us=COST, bucket_cap_us=CAP)


@pytest.mark.parametrize("branch", ["t_last_zero", "bucket_over_cap"])
@pytest.mark.parametrize("draws", ["rand16", "key"])
def test_fused_admission_batch_start_registers(branch, draws):
    """The two branches of the batch-start registers, which the kernels
    take over from the wrapper: t_last == 0 (the refill anchor is ts[0])
    and bucket > bucket_cap_us (the burst is capped), on given draws and
    on a key's, against JAX's fused_admission on the same numpy inputs."""
    rng = np.random.default_rng(700 + len(branch) + len(draws))
    n = 777
    for trial in range(4):
        c = _case(rng, n, t_last_zero=branch == "t_last_zero")
        if branch == "bucket_over_cap":
            c["bucket"] = np.int32(CAP + 1 + rng.integers(0, 3 * CAP))
        t = _tensors(c)
        if draws == "key":
            key = jax.random.split(jax.random.PRNGKey(int(rng.integers(
                0, 2**31))))[1]
            c["rand16"] = np.asarray(jax.random.randint(key, (n,), 0,
                                                        1 << 16, jnp.int32))
            port = fused_admission(
                t["t_i"], t["c_i"], t["ts"], t["lut"], t["bucket"],
                t["t_last"], key=torch.as_tensor(
                    np.asarray(key).astype(np.int64)),
                cost_us=COST, bucket_cap_us=CAP)
        else:
            port = _port(c)
        g_ref, b_ref = _jax(c, "pallas")
        assert_same(g_ref, port[0], f"{branch} granted trial={trial}")
        assert_same(b_ref, port[1], f"{branch} bucket trial={trial}")
        if branch == "bucket_over_cap":
            assert int(b_ref) <= CAP


RAGGED = [1, 7, 255, 256, 257, 1000]


def _tensors(c):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in c.items()}


@pytest.mark.parametrize("n", RAGGED)
def test_rate_gate_matches_jax(n):
    """Selection on given draws: the port's rate_gate (plain version)
    against JAX's rate_gate(..., backend="pallas"), which pads to 256
    lanes and runs the interpreted kernel."""
    rng = np.random.default_rng(300 + n)
    for trial in range(4):
        c = _case(rng, n, False)
        shifts = dict(t_shift=(10, 8)[trial % 2], c_shift=trial % 3)
        ref = j_rate_gate(jnp.asarray(c["t_i"]), jnp.asarray(c["c_i"]),
                          jnp.asarray(c["lut"]),
                          rand16=jnp.asarray(c["rand16"]), backend="pallas",
                          **shifts)
        t = _tensors(c)
        port = rate_gate(t["t_i"], t["c_i"], t["lut"], rand16=t["rand16"],
                         **shifts)
        assert port.dtype == torch.bool and port.shape == (n,)
        assert_same(ref, port, f"n={n} trial={trial}")


@pytest.mark.parametrize("n", RAGGED)
def test_seeded_rate_gate_matches_jax(n):
    """Seeded draws: the plain version of the drawing kernel against
    JAX's rate_gate(seed=s, rand16=None, backend="pallas"), which draws
    randint(PRNGKey(s), padded n) — the same lanes, whatever the pad."""
    rng = np.random.default_rng(400 + n)
    for seed in (0, 1, int(rng.integers(2, 2**31))):
        c = _case(rng, n, False)
        ref = j_rate_gate(jnp.asarray(c["t_i"]), jnp.asarray(c["c_i"]),
                          jnp.asarray(c["lut"]), seed=jnp.asarray(seed),
                          backend="pallas")
        t = _tensors(c)
        plain = gate_ref.rate_gate_prng_ref(t["t_i"], t["c_i"], t["lut"],
                                            prng.PRNGKey(seed), 10, 0, 16)
        via_op = rate_gate(t["t_i"], t["c_i"], t["lut"], seed=seed)
        assert_same(ref, plain, f"n={n} seed={seed}")
        assert_same(ref, via_op, f"n={n} seed={seed}")


@pytest.mark.parametrize("n", RAGGED + [3 * 8192 + 5])
def test_keyed_fused_admission_matches_jax(n):
    """The plain version of the drawing fused kernel: fused admission on
    the draws of a chunk's subkey, against JAX's fused_admission fed
    rand16=jax.random.randint(sub, (n,), 0, 2^16) (interpreted kernel;
    its "ref" backend past three CTA tiles)."""
    rng = np.random.default_rng(500 + n)
    for trial in range(4):
        c = _case(rng, n, t_last_zero=trial % 3 == 0)
        key = jax.random.split(jax.random.PRNGKey(int(rng.integers(
            0, 2**31))))[1]
        rand = jax.random.randint(key, (n,), 0, 1 << 16, jnp.int32)
        jc = dict(c, rand16=np.asarray(rand))
        g_ref, b_ref = _jax(jc, "pallas" if n <= 1000 else "ref")
        t = _tensors(c)
        tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
        t_ref = torch.where(t["t_last"] == 0, t["ts"][0], t["t_last"])
        burst0 = torch.clamp_max(t["bucket"], CAP)
        plain = gate_ref.fused_admission_prng_ref(
            t["t_i"], t["c_i"], t["ts"], t["lut"], tkey, burst0, t_ref, 10,
            0, COST, CAP, 16)
        via_op = fused_admission(t["t_i"], t["c_i"], t["ts"], t["lut"],
                                 t["bucket"], t["t_last"], key=tkey,
                                 cost_us=COST, bucket_cap_us=CAP)
        for got in (plain, via_op):
            assert_same(g_ref, got[0], f"granted n={n} trial={trial}")
            assert_same(b_ref, got[1], f"bucket n={n} trial={trial}")


def test_cuda_prng_backend_rejects_cpu_tensors():
    c = _case(np.random.default_rng(1), 8, False)
    t = _tensors(c)
    key = prng.PRNGKey(3)
    assert GATE_BACKENDS == ("cuda", "cuda_prng", "ref")
    assert validate_backend("cuda_prng") == "cuda_prng"
    with pytest.raises(ValueError, match="unknown gate_backend"):
        validate_backend("pallas_tpu")
    for backend in ("cuda", "cuda_prng"):
        with pytest.raises(ValueError, match="CUDA"):
            fused_admission(t["t_i"], t["c_i"], t["ts"], t["lut"],
                            t["bucket"], t["t_last"], key=key, cost_us=COST,
                            bucket_cap_us=CAP, backend=backend)
        with pytest.raises(ValueError, match="CUDA"):
            rate_gate(t["t_i"], t["c_i"], t["lut"], seed=3, backend=backend)
    with pytest.raises(ValueError, match="CUDA"):
        fused_gate_prng(t["t_i"], t["c_i"], t["ts"], key, t["lut"],
                        t["bucket"], t["t_last"], t_shift=10, c_shift=0,
                        prob_bits=16, cost_us=COST, bucket_cap_us=CAP)
    with pytest.raises(ValueError, match="CUDA"):
        rate_gate_prng(t["t_i"], t["c_i"], key, t["lut"], t_shift=10,
                       c_shift=0, prob_bits=16)
    with pytest.raises(ValueError, match="one of rand16= and key="):
        fused_admission(t["t_i"], t["c_i"], t["ts"], t["lut"], t["bucket"],
                        t["t_last"], cost_us=COST, bucket_cap_us=CAP)


def test_build_lut_torch_matches_jax():
    """The in-loop control-plane rebuild: every entry identical over a
    sweep of window counters, rates and LUT geometries."""
    rng = np.random.default_rng(1)
    flows = np.concatenate([[0, 1, 2, 3, 7, 40, 999, 1000, 4096],
                            rng.integers(0, 200_000, 30)])
    pkts = np.concatenate([[0, 1, 5, 1800, 10**6, 2**31 - 1],
                           rng.integers(0, 50_000_000, 30)])
    geoms = [(10, 0, 64, 32), (8, 1, 16, 8), (12, 2, 64, 64)]
    for v in (0.5859375, 0.013, 2.5):
        for ts_, cs_, tb, cb in geoms:
            jcfg = JLUTConfig(t_shift=ts_, c_shift=cs_, t_bins=tb, c_bins=cb)
            tcfg = LUTConfig(t_shift=ts_, c_shift=cs_, t_bins=tb, c_bins=cb)
            for f, q in zip(flows, rng.permutation(pkts)[:len(flows)]):
                ref = build_lut_jnp(jnp.asarray(f, jnp.int32),
                                    jnp.asarray(q, jnp.int32),
                                    window_us=1_000_000, v=v, cfg=jcfg)
                port = build_lut_torch(torch.tensor(f, dtype=torch.int32),
                                       torch.tensor(q, dtype=torch.int32),
                                       window_us=1_000_000, v=v, cfg=tcfg)
                assert port.dtype == torch.int32
                assert_same(ref, port, f"v={v} f={f} q={q} geom={tb}x{cb}")
