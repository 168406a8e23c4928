"""Parameter registration, the weight converter, and the layer loop.

Port of ``repro/models/param.py`` for one card.  A ``Registrar`` is
threaded through every ``init`` function and records each parameter's
shape, dtype and *logical* axes under its flat path
(``"layers/attn/wq/w"``).  In concrete mode it makes the reference's own
numpy draws (``_seed_for``: a sha256 of ``"seed:path"`` seeds
``default_rng``) and casts them to torch tensors; in abstract mode it
makes ``meta`` tensors, the counterpart of ``jax.ShapeDtypeStruct``.

Sharding has no meaning on one card: ``shard`` and ``replicate`` are the
identity, kept so that the layer code reads as the reference does.  The
reference's ``lax`` loops are here as plain PyTorch: ``maybe_scan`` (the
scan over layers) and ``associative_scan`` (JAX's log-depth algorithm).

A full-width model is billions of float64 normals (qwen2-moe-a2.7b's
``layers/moe/experts/wi_gate`` alone is one stream of 4.15 B values, 33
GB at once).  A concrete Registrar therefore fills each parameter's
tensor, already on its device, from consecutive draws of at most
``_CHUNK_ELEMS`` values (consecutive ``Generator.normal`` / ``uniform``
calls continue one stream, so the values are the one-shot draw's), each
cast on the host and copied over, so the host holds one chunk at a time
(:func:`fill_drawn`).  ``api.init_params`` runs these fills for
different parameters in a thread pool, from the ``inits`` an abstract
Registrar records.
"""

from __future__ import annotations

import hashlib
import math
from typing import (Any, Callable, Dict, Iterable, Iterator, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

Axes = Tuple[str, ...]


def shard(x: torch.Tensor, *axes: str) -> torch.Tensor:
    """The reference's sharding constraint: the identity on one card."""
    return x


def replicate(x: torch.Tensor) -> torch.Tensor:
    return x


def _seed_for(path: str, seed: int) -> np.random.Generator:
    h = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def _chunks(path: str, shape: Tuple[int, ...], init: str,
            scale: Optional[float], seed: int, rows: int
            ) -> Iterator[np.ndarray]:
    """The reference Registrar's float64 draw for one parameter as
    consecutive blocks of at most ``rows`` leading rows (a random draw
    continues one generator's stream block to block; a normal draw's
    blocks share one array, each valid until the next)."""
    if init in ("zeros", "ones"):
        yield (np.zeros if init == "zeros" else np.ones)(shape)
        return
    if init == "normal":
        if scale is None:
            # fan-in scaling over the last-but-one dims heuristically:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = fan_in ** -0.5
    elif init == "uniform":
        scale = scale if scale is not None else 1.0
    else:
        raise ValueError(init)
    rng = _seed_for(path, seed)
    n = shape[0] if shape else 1
    buf = None
    for lo in range(0, n, rows):
        size = (min(rows, n - lo), *shape[1:]) if shape else ()
        if init == "uniform":
            yield np.asarray(rng.uniform(-scale, scale, size=size))
            continue
        # Generator.normal(0.0, scale) computes 0.0 + scale * z for each
        # standard normal z; the same arithmetic in one buffer, reused
        # block to block, spares the host a fresh GiB of pages a block
        if buf is None or buf.shape != size:
            buf = np.empty(size)
        rng.standard_normal(out=buf)
        buf *= scale
        buf += 0.0
        yield buf


def draw(path: str, shape: Sequence[int], init: str, scale: Optional[float],
         seed: int) -> np.ndarray:
    """The reference Registrar's float64 numpy draw for one parameter."""
    shape = tuple(int(s) for s in shape)
    return next(_chunks(path, shape, init, scale, seed, max(shape[:1],
                                                            default=1)))


# the most values one draw of a parameter makes at once (1 GiB of
# float64); a longer draw continues its stream chunk by chunk
_CHUNK_ELEMS = 1 << 27


def fill_drawn(out: torch.Tensor, path: str, init: str,
               scale: Optional[float], seed: int) -> torch.Tensor:
    """Write :func:`draw`'s values for ``path`` into ``out`` (any device
    and dtype), chunk by chunk along the leading axis: each chunk is
    drawn in float64, cast to ``out``'s dtype on the host and copied."""
    shape = tuple(out.shape)
    rows = max(1, _CHUNK_ELEMS // max(math.prod(shape[1:]), 1))
    lo = 0
    for vals in _chunks(path, shape, init, scale, seed, rows):
        part = torch.from_numpy(vals).to(out.dtype)
        if vals.shape == shape:
            out.copy_(part)
        else:
            out[lo:lo + len(vals)].copy_(part)
            lo += len(vals)
    return out


class Registrar:
    """Records parameter metadata (shape, dtype, logical axes, and the
    draw's ``(init, scale)`` in ``inits``); materializes concretely (on
    ``device``, each parameter drawn by :func:`fill_drawn`) or abstractly
    (``meta`` tensors)."""

    def __init__(self, abstract: bool = False, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = "cpu"):
        self.abstract = abstract
        self.seed = seed
        self.default_dtype = dtype
        self.device = torch.device("meta" if abstract else device)
        self.params: Dict[str, torch.Tensor] = {}
        self.axes: Dict[str, Axes] = {}
        self.inits: Dict[str, Tuple[str, Optional[float]]] = {}

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
        self.inits[path] = (init, scale)
        val = torch.empty(shape, dtype=dtype, device=self.device)
        if not self.abstract:
            # the float64 draw cast to dtype on the host, bit for bit the
            # reference's jnp.asarray cast of the same draw
            fill_drawn(val, path, init, scale, self.seed)
        self.params[path] = val
        return val


def subtree(params: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """Extract a flat sub-dict (keys relative to prefix)."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def maybe_scan(body: Callable, carry, stacked: Dict[str, Any],
               use_scan: bool = True):
    """The reference's ``lax.scan`` over layers as a Python loop (eager
    PyTorch has no scan to choose: ``use_scan``, the reference's choice
    between its scan and its unrolled loop, runs the same loop for both
    values, with the same bits).

    ``stacked``: a dict, or a tuple of dicts, of tensors with equal
    leading dims; ``body(carry, slice)`` -> (carry, ys_slice), ys_slice
    a dict of tensors or None.  The ys are stacked along a new leading
    dim.  Under autograd each stacked tensor is split once
    (``unbind``: its backward stacks the layers' gradients in one write,
    where a layer's ``select`` would zero-fill and add a whole stack per
    layer); serving indexes it, so a layer's in-place writes land in the
    stacked tensor (a cache).
    """
    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(split(v) for v in tree)
        return list(tree.unbind(0)) if tree.requires_grad else tree

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(take(v, i) for v in tree)
        return tree[i]      # a tensor's row, or a split tensor's layer

    def first_leaf(tree):
        while isinstance(tree, (dict, tuple)):
            tree = next(iter(tree.values() if isinstance(tree, dict)
                             else tree))
        return tree

    n = first_leaf(stacked).shape[0]
    if torch.is_grad_enabled():
        stacked = split(stacked)
    ys_list = []
    for i in range(n):
        carry, ys = body(carry, take(stacked, i))
        ys_list.append(ys)
    if not ys_list or ys_list[0] is None:
        return carry, None
    return carry, {k: torch.stack([y[k] for y in ys_list], 0)
                   for k in ys_list[0]}


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     axis: int = 0) -> Tuple[torch.Tensor, ...]:
    """``jax.lax.associative_scan`` (forward), JAX's algorithm: combine
    adjacent pairs, scan the half-length result recursively, then combine
    it with the remaining even elements and interleave, so the depth is
    log2 of the length and every level is a few whole-tensor ops (the
    same ``fn`` calls on the same operands as the reference, so the same
    roundings).  ``fn(left, right)`` takes and returns tuples of tensors
    of one shape."""
    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]

    def interleave(a, b):
        shape = list(a.shape)
        shape[axis] = a.shape[axis] + b.shape[axis]
        out = a.new_empty(shape)
        sl(out, 0, None, 2).copy_(a)
        sl(out, 1, None, 2).copy_(b)
        return out

    def scan(xs):
        n = xs[0].shape[axis]
        if n < 2:
            return xs
        odd = scan(fn(tuple(sl(x, 0, -1, 2) for x in xs),
                      tuple(sl(x, 1, None, 2) for x in xs)))
        rest = tuple(sl(x, 2, None, 2) for x in xs)
        even = fn(tuple(sl(o, 0, -1) for o in odd) if n % 2 == 0 else odd,
                  rest)
        even = tuple(torch.cat([sl(x, 0, 1), e], dim=axis)
                     for x, e in zip(xs, even))
        return tuple(interleave(e, o) for e, o in zip(even, odd))

    return scan(tuple(elems))


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)     # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (JAX's): the same 16 bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(params: Dict[str, Any], device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """The weight converter: the reference's flat parameter dict, as
    numpy arrays (``np.asarray`` of each JAX array), -> the port's
    tensors on ``device`` (``None`` means ``cuda``, and raises without
    it, as every entry point of the port), key for key and bit for bit.
    JAX's bfloat16 arrays arrive as the ``bfloat16`` numpy dtype and are
    reinterpreted through ``uint16``, so neither JAX nor ``ml_dtypes`` is
    imported."""
    dev = resolve_device(device)
    return {k: _tensor_from_numpy(v).to(dev) for k, v in params.items()}
