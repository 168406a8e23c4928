"""The port's decode attention (TPU kernel 4) against the JAX package on
the CPU: its plain version against ``decode_attention_ref`` and against
the Pallas kernel in interpret mode, and the backend rules of ``ops``.
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
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref as port_ref)
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
                                 for i, x in enumerate(jax_in)})
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
