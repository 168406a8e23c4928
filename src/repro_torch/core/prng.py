"""Bit-exact port of the ``jax.random`` threefry functions the data plane
draws from: ``PRNGKey``, ``split`` and ``randint``.

It follows JAX 0.9 with ``jax_threefry_partitionable=True`` (the
default): ``split`` is ``_threefry_split_foldlike`` and random bits are
``_threefry_random_bits_partitionable`` (``jax/_src/prng.py``), and
``randint`` is ``jax/_src/random.py::_randint``.  A key is a [2] int64
tensor holding two uint32 words, as JAX's legacy uint32 keys do; a
stack of keys [..., 2] (one a pipe) splits and draws key by key, as
``vmap(jax.random.split)`` / ``vmap(jax.random.randint)`` do.  All
uint32 arithmetic runs in int64 and is masked with ``& 0xFFFFFFFF``;
products of two 32-bit words are split into 16-bit halves
(:func:`mul_u32`) so no intermediate passes 2^63 on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """uint32 wraparound product of int64 tensors holding uint32 words
    (``b`` may be a Python int)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of count words (x1, x2) under
    key (k1, k2); every argument holds uint32 values in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed]."""
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def _iota_split(key: torch.Tensor, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32(key, (0, i)) for i < n, [..., n] for keys [..., 2]:
    the partitionable layout's counts (``iota_2x32_shape``: high word 0,
    low word i)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [..., num, 2] keys for keys
    [..., 2]."""
    b1, b2 = _iota_split(key, num)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``_threefry_random_bits_partitionable(key, 32, (n,))`` in int64,
    [..., n] for keys [..., 2]."""
    b1, b2 = _iota_split(key, n)
    return b1 ^ b2


def randint_multiplier(span: int) -> int:
    """2^32 % span as ``randint`` computes it, in wrapping uint32:
    ((2^16 % span)^2 mod 2^32) % span.  It is 0 for every power-of-two
    span, and then only the bits of ``split(key)[1]`` reach the draw."""
    return ((((1 << 16) % span) ** 2) & M32) % span


def randint(key: torch.Tensor, n: int, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval, jnp.int32)`` for
    static int32 bounds -> [n] int32 ([..., n] for keys [..., 2]).
    maxval may also be 2^31, as JAX takes it with 64-bit integers on: the
    span [0, 2^31) of a 31-bit draw."""
    if not (-2**31 <= minval < 2**31 and -2**31 <= maxval <= 2**31
            and maxval - minval < 2**32):
        raise ValueError("randint bounds must be int32 (maxval up to "
                         "2^31), spanning less than 2^32")
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = randint_multiplier(span)
    keys = split(key)
    k1, k2 = keys[..., 0, :], keys[..., 1, :]
    lower = random_bits32(k2, n)
    offset = lower % span
    if multiplier:
        higher = random_bits32(k1, n)
        offset = ((mul_u32(higher % span, multiplier) + offset) & M32) \
            % span
    return ((offset + minval) & M32).to(torch.int32)
