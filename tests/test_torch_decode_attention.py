"""The port's decode attention (TPU kernel 4) against the JAX package on
the CPU: its plain version against ``decode_attention_ref`` and against
the Pallas kernel in interpret mode, the plain version of the kernel's
split-and-merge algorithm against both, the kernel's split rule, and the
backend rules of ``ops``.
The hand-written CUDA kernel itself runs only on the card
(tests/test_torch_on_card.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import kernel, ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref as port_ref)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_split_ref as split_ref, split_bounds)
from repro_torch.models import layers
from repro_torch.models.param import params_from_numpy

# the reference test's bounds (tests/test_kernels.py): float32 1e-5 (sums
# in another order), bfloat16 3e-2 (the output is rounded to bfloat16)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}

# (b, hq, hkv, d, s, ck): the reference test's four shapes, then head_dim
# 256 and a group of 5
SHAPES = [(2, 8, 2, 64, 256, 128), (1, 4, 1, 128, 512, 256),
          (3, 16, 8, 32, 128, 64), (2, 8, 8, 64, 320, 64),
          (2, 4, 2, 256, 128, 64), (2, 10, 2, 16, 192, 64)]


def _case(shape, dtype, seed, empty=False):
    b, hq, hkv, d, s, _ = shape
    rng = np.random.default_rng(seed)
    jdt = getattr(jnp, dtype)
    q = jnp.asarray(rng.normal(0, 1, (b, hq, d)), jdt)
    k = jnp.asarray(rng.normal(0, 1, (b, s, hkv, d)), jdt)
    v = jnp.asarray(rng.normal(0, 1, (b, s, hkv, d)), jdt)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    if empty:
        lens[-1] = 0
    jax_in = (q, k, v, jnp.asarray(lens))
    port_in = params_from_numpy({i: np.asarray(x)
                                 for i, x in enumerate(jax_in)}, "cpu")
    return jax_in, tuple(port_in[i] for i in range(4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_port_ref_matches_jax_ref(shape, dtype):
    jax_in, port_in = _case(shape, dtype, seed=sum(shape))
    want = np.asarray(decode_attention_ref(*jax_in), np.float32)
    got = port_ref(*port_in)
    assert got.dtype == getattr(torch, dtype)
    assert_close(want, got.float(), TOL[dtype], f"{shape} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_port_ref_matches_pallas_interpret(shape, dtype):
    jax_in, port_in = _case(shape, dtype, seed=10 + sum(shape))
    want = np.asarray(decode_attention_pallas(*jax_in, ck=shape[-1],
                                              interpret=True), np.float32)
    assert_close(want, port_ref(*port_in).float(), TOL[dtype],
                 f"{shape} {dtype}")


def test_empty_row():
    """An empty row (length 0): the Pallas kernel gives 0 (acc / max(l,
    1e-30)), which the CUDA kernel reproduces on the card; the plain
    versions give NaN, as the reference's oracle does.  The serving path
    never has one (lengths = pos + 1)."""
    shape = (3, 8, 2, 64, 128, 64)
    jax_in, port_in = _case(shape, "float32", seed=3, empty=True)
    pal = np.asarray(decode_attention_pallas(*jax_in, ck=64, interpret=True))
    assert np.all(pal[-1] == 0)
    got = port_ref(*port_in).numpy()
    assert np.isnan(got[-1]).all()
    assert np.isnan(np.asarray(decode_attention_ref(*jax_in))[-1]).all()
    assert_close(pal[:-1], got[:-1], TOL["float32"], "rows with keys")


def test_backend_rules():
    _, (q, k, v, lens) = _case(SHAPES[0], "float32", seed=4)
    want = port_ref(q, k, v, lens)
    assert torch.equal(ops.decode_attention(q, k, v, lens), want)
    assert torch.equal(ops.decode_attention(q, k, v, lens, backend="ref"),
                       want)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, k, v, lens, backend="cuda")
    with pytest.raises(ValueError, match="unknown attn_backend"):
        ops.decode_attention(q, k, v, lens, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        layers.decode_attention(q, k, v, lens, backend="cuda")


# -- the kernel's split-and-merge algorithm and its split rule ---------------

def _split_case(seed, b, hkv, g, d, s, lens):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, hkv * g, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jax_in = tuple(jnp.asarray(x) for x in (q, k, v, lens))
    return jax_in, tuple(torch.from_numpy(x) for x in (q, k, v, lens))


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 64])
def test_split_ref_matches_jax_ref_and_pallas(splits, d):
    """The plain split-and-merge version (per-split float32 partials
    merged in split order with the isinf guards) against the reference's
    decode_attention_ref and the Pallas kernel in interpret mode, float32
    within 1e-6: lengths S, 1, one inside the first split (so the later
    splits lie wholly past it), a ragged one and an empty row (0, as the
    Pallas kernel gives)."""
    b, hkv, g, s = 5, 2, 4, 256
    rows = kernel.tile_rows(d, 4, False)
    lens = [s, 1, s // splits // 2 + 1, 171, 0]
    jax_in, port_in = _split_case(splits * d, b, hkv, g, d, s, lens)
    got = split_ref(*port_in, splits=splits, rows=rows)
    pal = np.asarray(decode_attention_pallas(*jax_in, ck=64,
                                             interpret=True))
    assert_close(pal, got, 1e-6, f"pallas splits={splits}")
    assert np.all(got[-1].numpy() == 0)
    want = np.asarray(decode_attention_ref(*jax_in))
    assert_close(want[:-1], got[:-1], 1e-6, f"ref splits={splits}")
    bounds = split_bounds(s, splits, rows)
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(hi > lo for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert lens[2] <= bounds[0][1] or splits == 1


def test_split_rule_depends_on_shapes_only():
    """num_splits gives 1, 2, 4 or 8, never more than the tiles of S (no
    split empty by capacity), from integers alone; at the Llama decode
    shape (B=8, Hkv=8, S=4128, D=64, bf16) on 132 SMs it gives 4 and at
    B=32, S=32768 it gives 2, the counts the H100 measured fastest
    (PERF.md)."""
    for b in (1, 2, 8, 32, 128):
        for hkv in (1, 2, 8):
            for s in (1, 15, 16, 17, 100, 4128, 32768):
                for d in kernel.HEAD_DIMS:
                    for kv_bytes, mma in ((4, False), (2, False), (2, True)):
                        rows = kernel.tile_rows(d, kv_bytes, mma)
                        n = kernel.num_splits(b, hkv, s, rows, 132)
                        assert n in kernel.SPLITS
                        assert n <= max(1, -(-s // rows))
                        assert n == kernel.num_splits(b, hkv, s, rows, 132)
    rows = kernel.tile_rows(64, 2, kernel.tensor_cores(torch.bfloat16,
                                                       torch.bfloat16))
    assert rows == 16
    assert kernel.num_splits(8, 8, 4128, rows, 132) == 4
    assert kernel.num_splits(32, 8, 32768, rows, 132) == 2
    assert kernel.num_splits(1, 8, 4128, rows, 132) == 8
    assert kernel.num_splits(8, 8, 4128, rows, 66) == 2
