"""The port's threefry draws (repro_torch.core.prng) are bit-identical to
jax.random: PRNGKey, split and randint over many seeds and sizes."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = list(range(200)) + [2**16 + 3, 2**24 - 1, 2**31 - 1, 123456789]


def test_prng_key_matches_jax():
    for seed in SEEDS:
        assert_same(jax.random.PRNGKey(seed), prng.PRNGKey(seed),
                    f"seed={seed}")


def test_split_matches_jax():
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for num in (2, 3, 5):
            assert_same(jax.random.split(jk, num), prng.split(tk, num),
                        f"seed={seed} num={num}")
        # chained splits, as the data plane walks its key batch by batch
        for _ in range(3):
            jk, jsub = jax.random.split(jk)
            tk, tsub = prng.split(tk)
            assert_same(jsub, tsub, f"seed={seed} chained")


@pytest.mark.parametrize("n", [1, 7, 256, 1000, 4096])
def test_randint_prob_bits_matches_jax(n):
    """The data plane's draw: randint(sub, (n,), 0, 1 << 16, int32)."""
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        _, jsub = jax.random.split(jk)
        _, tsub = prng.split(tk)
        ref = jax.random.randint(jsub, (n,), 0, 1 << 16, jnp.int32)
        port = prng.randint(tsub, n, 0, 1 << 16)
        assert port.dtype == torch.int32
        assert_same(ref, port, f"seed={seed} n={n}")


@pytest.mark.parametrize("lo,hi", [(0, 3), (-5, 100), (0, 1000003),
                                   (-2**31, 2**31 - 1), (0, 2**31 - 1),
                                   (7, 7), (9, 2)])
def test_randint_bounds_match_jax(lo, hi):
    """Spans that are not powers of two take the two-word path."""
    for seed in range(40):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        ref = jax.random.randint(jk, (333,), lo, hi, jnp.int32)
        assert_same(ref, prng.randint(tk, 333, lo, hi), f"seed={seed}")


@pytest.mark.parametrize("lo,hi", [(0, 2**31), (7, 2**31),
                                   (-2**31 + 1, 2**31)])
def test_randint_maxval_2_31_matches_jax(lo, hi):
    """maxval 2^31 (which JAX takes with 64-bit integers on): [0, 2^31)
    is the gate's draw at prob_bits 31."""
    for seed in range(8):
        with jax.enable_x64(True):
            ref = jax.random.randint(jax.random.PRNGKey(seed), (333,), lo,
                                     hi, jnp.int32)
        assert_same(ref, prng.randint(prng.PRNGKey(seed), 333, lo, hi),
                    f"seed={seed}")


@pytest.mark.parametrize("lo,hi", [(-2**31, 2**31), (0, 2**31 + 1),
                                   (-2**31 - 1, 0)])
def test_randint_refuses_bounds_past_its_range(lo, hi):
    with pytest.raises(ValueError, match="randint bounds"):
        prng.randint(prng.PRNGKey(0), 4, lo, hi)


def test_mul_u32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 10000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 10000, dtype=np.uint64).astype(np.uint32)
    want = (a.astype(np.uint64) * b.astype(np.uint64)) & 0xFFFFFFFF
    got = prng.mul_u32(torch.from_numpy(a.astype(np.int64)),
                       torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
