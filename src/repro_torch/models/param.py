"""Parameter registration, the weight converter, and the layer loop.

Port of ``repro/models/param.py`` for one card.  A ``Registrar`` is
threaded through every ``init`` function and records each parameter's
shape, dtype and *logical* axes under its flat path
(``"layers/attn/wq/w"``).  In concrete mode it makes the reference's own
numpy draws (``_seed_for``: a sha256 of ``"seed:path"`` seeds
``default_rng``) and casts them to torch tensors; in abstract mode it
makes ``meta`` tensors, the counterpart of ``jax.ShapeDtypeStruct``.

Sharding has no meaning on one card: ``shard`` and ``replicate`` are the
identity, kept so that the layer code reads as the reference does.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike

Axes = Tuple[str, ...]


def shard(x: torch.Tensor, *axes: str) -> torch.Tensor:
    """The reference's sharding constraint: the identity on one card."""
    return x


def replicate(x: torch.Tensor) -> torch.Tensor:
    return x


def _seed_for(path: str, seed: int) -> np.random.Generator:
    h = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def draw(path: str, shape: Sequence[int], init: str, scale: Optional[float],
         seed: int) -> np.ndarray:
    """The reference Registrar's float64 numpy draw for one parameter."""
    shape = tuple(int(s) for s in shape)
    if init == "normal":
        if scale is None:
            # fan-in scaling over the last-but-one dims heuristically:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = fan_in ** -0.5
        return _seed_for(path, seed).normal(0.0, scale, size=shape)
    if init == "zeros":
        return np.zeros(shape)
    if init == "ones":
        return np.ones(shape)
    if init == "uniform":
        s = scale if scale is not None else 1.0
        return _seed_for(path, seed).uniform(-s, s, size=shape)
    raise ValueError(init)


class Registrar:
    """Records parameter metadata; materializes concretely (on
    ``device``) or abstractly (``meta`` tensors)."""

    def __init__(self, abstract: bool = False, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = "cpu"):
        self.abstract = abstract
        self.seed = seed
        self.default_dtype = dtype
        self.device = torch.device("meta" if abstract else device)
        self.params: Dict[str, torch.Tensor] = {}
        self.axes: Dict[str, Axes] = {}

    def param(self, path: str, shape: Sequence[int], axes: Iterable[str],
              init: str = "normal", scale: Optional[float] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        axes = tuple(axes)
        shape = tuple(int(s) for s in shape)
        if len(axes) != len(shape):
            raise ValueError(f"{path}: shape {shape} vs axes {axes}")
        if path in self.params:
            raise ValueError(f"duplicate param {path}")
        dtype = dtype or self.default_dtype
        self.axes[path] = axes
        if self.abstract:
            val = torch.empty(shape, dtype=dtype, device="meta")
        else:
            # the float64 draw cast to dtype, bit for bit the reference's
            # jnp.asarray cast of the same draw
            val = torch.from_numpy(draw(path, shape, init, scale, self.seed)) \
                .to(device=self.device, dtype=dtype)
        self.params[path] = val
        return val


def subtree(params: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """Extract a flat sub-dict (keys relative to prefix)."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def maybe_scan(body: Callable, carry, stacked: Dict[str, Any]):
    """The reference's ``lax.scan`` over layers as a Python loop (eager
    PyTorch has no scan to choose).

    ``stacked``: a dict, or a tuple of dicts, of tensors with equal
    leading dims; ``body(carry, slice)`` -> (carry, ys_slice), ys_slice
    a dict of tensors or None.  The ys are stacked along a new leading
    dim.
    """
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(take(v, i) for v in tree)
        return tree[i]

    def first_leaf(tree):
        while isinstance(tree, (dict, tuple)):
            tree = next(iter(tree.values() if isinstance(tree, dict)
                             else tree))
        return tree

    n = first_leaf(stacked).shape[0]
    ys_list = []
    for i in range(n):
        carry, ys = body(carry, take(stacked, i))
        ys_list.append(ys)
    if not ys_list or ys_list[0] is None:
        return carry, None
    return carry, {k: torch.stack([y[k] for y in ys_list], 0)
                   for k in ys_list[0]}


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)     # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (JAX's): the same 16 bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(params: Dict[str, Any], device: DeviceLike = "cpu"
                      ) -> Dict[str, torch.Tensor]:
    """The weight converter: the reference's flat parameter dict, as
    numpy arrays (``np.asarray`` of each JAX array), -> the port's
    tensors on ``device``, key for key and bit for bit.  JAX's bfloat16
    arrays arrive as the ``bfloat16`` numpy dtype and are reinterpreted
    through ``uint16``, so neither JAX nor ``ml_dtypes`` is imported."""
    return {k: _tensor_from_numpy(v).to(device) for k, v in params.items()}
