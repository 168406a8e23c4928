"""Single-card dry run: trace one (arch x shape) step on ``meta`` tensors,
the one-card counterpart of the reference's multi-pod lower-and-compile
(``repro/launch/dryrun.py``).  It draws nothing, allocates nothing on a
device and needs no card, as the reference needs no TPU.

The parameters come from ``api.init_params(abstract=True)`` (int8 for an
int8 config outside training), the batch and the decode cache from
``api.input_specs`` and the optimizer state from
``optimizer.abstract_state``.  The step runs op by op on those meta
tensors along the card's path (``_device.meta_as``: the decode-attention
kernel's custom op, ``layers._MatmulF32``), under counters built on
``TorchDispatchMode``.  For the cell this gives:
  - memory: argument, output and temp bytes, temp being the peak of the
    step's own allocations (each storage once, from its creation to its
    release, rounded as the card's caching allocator rounds), and
    ``fits_card``: arguments plus temp against the card's memory
  - cost: FLOPs (``FlopCounterMode``: the matrix products, kernel 4's by
    its formula), bytes accessed (operand plus result bytes of every op
    that moves data: the unfused sum, the counterpart of XLA's ``bytes
    accessed``) and transcendentals (result elements of exp, log, tanh,
    sigmoid, rsqrt and their kin)
  - op_bytes: bytes written by aten op, the top 24 (the counterpart of
    the reference's HLO opcode histogram)
  - collectives: none; one card has no interconnect (the reference
    parses them from the post-SPMD HLO, and the port emits no HLO)
written as JSON.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape decode_32k [--set attention_impl=chunked] [--reduced] \\
      [--out results.json]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._device import meta_as
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import shape_applicable
from repro_torch.launch.mesh import check_card_mesh
from repro_torch.models import api
from repro_torch.train import optimizer as opt_lib

# NVIDIA H100 SXM: 80 GB of HBM3 (data sheet); the card's own
# total_memory when one is present
H100_BYTES = 80 * 10 ** 9
# the CUDA caching allocator rounds every block up to 512 bytes
ALLOC_GRANULE = 512
# ops that allocate without moving data
_ALLOCATORS = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided"})
# ops whose result elements each cost a transcendental
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "erfc", "erfinv",
    "_softmax", "_log_softmax"})
# in-place ops that write rows of their first operand from a source
# operand (``source`` / ``values`` / ``src``): they move the source, not
# the whole operand
_INDEXED_WRITES = frozenset({
    "index_copy", "index_put", "index_add", "index_reduce", "scatter",
    "scatter_add", "scatter_reduce", "masked_scatter", "_index_put_impl"})
_SOURCES = ("source", "values", "src")
# in-place ops that write their operand without reading it
_WRITE_ONLY = frozenset({"copy", "fill", "zero", "normal", "uniform",
                         "random"})
NO_COLLECTIVES = {"per_op": {}, "total_bytes": 0.0,
                  "note": "one card: no collectives"}


def apply_overrides(cfg, overrides: Dict[str, str]):
    """``--set key=value`` config overrides (``moe.top_k=2`` reaches a
    sub-config), as the reference's."""
    for key, val in overrides.items():
        parts = key.split(".")

        def parse(v):
            for cast in (int, float):
                try:
                    return cast(v)
                except ValueError:
                    pass
            if v in ("true", "false", "True", "False"):
                return v.lower() == "true"
            return v
        v = parse(val)
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: v})
        elif len(parts) == 2:
            sub = getattr(cfg, parts[0])
            cfg = dataclasses.replace(
                cfg, **{parts[0]: dataclasses.replace(sub, **{parts[1]: v})})
        else:
            raise ValueError(key)
    return cfg


# ---------------------------------------------------------------------------
# Step builder
# ---------------------------------------------------------------------------


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in _leaves(tree))


def build_step(cfg, shape) -> Tuple[Callable, Tuple, Dict[str, int]]:
    """The counterpart of the reference's ``build_lowered``: (step, its
    meta arguments, {n_params, arg_bytes_global}).

    train   step(params, opt_state, batch) -> (params, opt_state,
            metrics): ``api.loss_fn``, ``torch.autograd.grad`` and the
            port's AdamW (``optimizer.make_train_step``), functional
    prefill step(params, batch) -> (cache, logits)
    decode  step(params, cache, tokens) -> (cache, logits), the cache
            written in place
    """
    params, axes = api.init_params(cfg, abstract=True)
    if cfg.quant == "int8" and shape.kind != "train":
        params, axes = api.quantize_for_serving(cfg, params, axes)
    specs = api.input_specs(cfg, shape)
    n_params = sum(v.numel() for v in params.values())
    if shape.kind == "train":
        step = opt_lib.make_train_step(lambda p, b: api.loss_fn(p, cfg, b),
                                       opt_lib.OptConfig())
        args = (params, opt_lib.abstract_state(params), specs)
    elif shape.kind == "prefill":
        def step(params, batch):
            return api.prefill(params, cfg, batch)
        args = (params, specs)
    else:
        def step(params, cache, tokens):
            return api.decode_step(params, cfg, cache, tokens)
        args = (params, specs["cache"], specs["tokens"])
    return step, args, {"n_params": n_params,
                        "arg_bytes_global": _tree_bytes(args)}


# ---------------------------------------------------------------------------
# The trace's counters
# ---------------------------------------------------------------------------


def _extent(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` spans once: a broadcast (stride 0)
    dimension is read once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n if t.numel() else 0


def _granules(nbytes: int) -> int:
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


class StepCounters(TorchDispatchMode):
    """Counts what the ops of a block move and allocate on ``device``:
    ``bytes_accessed`` (operands plus results of every op but views and
    bare allocations; an in-place op reads its other operands and reads
    and writes the one it mutates, a row write such as ``index_copy_``
    only its source's rows), ``transcendentals``, ``op_bytes`` (bytes
    written by op) and the live bytes of the storages the block creates:
    ``peak`` (their most at once) and ``live``.  A storage is counted
    once, its views not again, from the op that creates it until it is
    freed (a weak reference's callback, which may run on an autograd
    worker thread).  Storages of ``args`` (and of CPU scalars on a card
    trace) are not the block's allocations."""

    def __init__(self, args=(), device: Optional[torch.device] = None):
        super().__init__()
        self.device = device
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.op_bytes: Dict[str, int] = collections.Counter()
        self.live = 0
        self.peak = 0
        self._lock = threading.Lock()
        self._sizes: Dict[int, int] = {}      # storage id -> counted bytes
        self._refs: Dict[int, weakref.ref] = {}
        self._args = {t.untyped_storage()._cdata for t in _leaves(args)}

    def _freed(self, key: int, _ref) -> None:
        with self._lock:
            self.live -= self._sizes.pop(key, 0)
            self._refs.pop(key, None)

    def _track(self, t: torch.Tensor) -> None:
        if self.device is not None and t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        size = _granules(st.nbytes())
        with self._lock:
            old = self._sizes.get(key)
            if old is None:
                self._refs[key] = weakref.ref(
                    st, lambda r, k=key: self._freed(k, r))
            self._sizes[key] = size
            self.live += size - (old or 0)
            self.peak = max(self.peak, self.live)

    @staticmethod
    def _moved(func, args, kwargs, outs) -> Tuple[int, int]:
        """(bytes the op reads and writes, bytes it writes); (0, 0) for a
        view or a bare allocation."""
        name = func._overloadpacket.__name__.rstrip("_")
        schema = func._schema
        if name in _ALLOCATORS:
            return 0, 0
        if not schema.is_mutable:
            ins = {t.untyped_storage()._cdata
                   for t in _leaves((args, kwargs))}
            if all(t.untyped_storage()._cdata in ins for t in outs):
                return 0, 0                     # a view
            written = sum(_extent(t) for t in outs)
            return sum(_extent(t) for t in _leaves((args, kwargs))) \
                + written, written
        named = dict(kwargs)
        named.update((a.name, v) for a, v in zip(schema.arguments, args))
        mutated = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        reads = sum(_extent(t) for k, v in named.items()
                    if k not in mutated for t in _leaves(v))
        if name in _INDEXED_WRITES:
            written = sum(_extent(t) for k in _SOURCES
                          for t in _leaves(named.get(k)))
            return reads + written, written
        written = sum(_extent(t) for k in mutated
                      for t in _leaves(named.get(k)))
        if name not in _WRITE_ONLY:
            reads += written
        return reads + written, written

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_leaves(out))
        moved, written = self._moved(func, args, kwargs, outs)
        if moved:
            name = func._overloadpacket.__name__
            self.bytes_accessed += moved
            self.op_bytes[name] += written
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self._track(t)
        return out


def trace(step: Callable, args: Tuple, device_type: str = "cuda"
          ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``step(*args)`` once under the counters (meta arguments take
    ``device_type``'s path, the card's by default): (its outputs, the
    counts)."""
    leaves = list(_leaves(args))
    device = leaves[0].device if leaves else None
    arg_st = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
              for t in leaves}
    with meta_as(device_type), FlopCounterMode(display=False) as fc, \
            StepCounters(args, device) as c:
        out = step(*args)
    out_st = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
              for t in _leaves(out)
              if t.untyped_storage()._cdata not in arg_st}
    return out, {
        "flops": float(fc.get_total_flops()),
        "bytes_accessed": float(c.bytes_accessed),
        "transcendentals": float(c.transcendentals),
        "op_bytes": dict(collections.Counter(c.op_bytes).most_common(24)),
        "argument_bytes": sum(arg_st.values()),
        "output_bytes": sum(out_st.values()),
        "temp_bytes": c.peak,
    }


# ---------------------------------------------------------------------------
# Main cell runner
# ---------------------------------------------------------------------------


def card_bytes() -> int:
    """The card's memory: its ``total_memory`` when one is present, else
    an H100's 80 GB."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_BYTES


def run_cell(arch: str, shape_name: str, mesh_kind: str = "card",
             overrides: Optional[Dict[str, str]] = None,
             rule_overrides: Optional[Dict[str, Any]] = None, *,
             reduced: bool = False, batch: Optional[int] = None,
             seq_len: Optional[int] = None) -> Dict[str, Any]:
    """Trace one cell on meta tensors: the reference's keys (``trace_s``
    in place of ``lower_s`` / ``compile_s``) with ``chips`` 1 and
    ``mesh`` "card", and ``fits_card``.  ``reduced`` takes the config's
    ``reduced()`` widths; ``batch`` / ``seq_len`` cut the shape (recorded
    as ``global_batch`` / ``seq_len``).  A ``mesh_kind`` other than
    "card", or any ``rule_overrides``, raises (``mesh.check_card_mesh``)."""
    check_card_mesh(mesh_kind, rule_overrides)
    overrides = dict(overrides or {})
    cfg = apply_overrides(get_config(arch, reduced=reduced), overrides)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(
        shape, global_batch=batch or shape.global_batch,
        seq_len=seq_len or shape.seq_len)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    t0 = time.time()
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": {"card": 1}, "chips": 1, "overrides": overrides,
        "rules": {}, "reduced": reduced,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
    }
    step, args, meta = build_step(cfg, shape)
    result["n_params"] = meta["n_params"]
    _, counts = trace(step, args)
    result["trace_s"] = round(time.time() - t0, 2)
    mem = {k: counts[k] for k in ("argument_bytes", "output_bytes",
                                  "temp_bytes")}
    # one card holds every argument whole
    mem["arg_bytes_global_analytic"] = meta["arg_bytes_global"]
    mem["arg_bytes_per_device_analytic"] = meta["arg_bytes_global"]
    result["memory"] = mem
    result["cost"] = {k: counts[k] for k in ("flops", "bytes_accessed",
                                             "transcendentals")}
    result["collectives"] = dict(NO_COLLECTIVES)
    result["op_bytes"] = counts["op_bytes"]
    result["card_bytes"] = card_bytes()
    result["fits_card"] = (mem["argument_bytes"] + mem["temp_bytes"]
                           <= result["card_bytes"])
    result["status"] = "ok"
    result["total_s"] = round(time.time() - t0, 2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="card",
                    help="card (the TPU pod meshes have no counterpart)")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (attention_impl=chunked)")
    ap.add_argument("--rule", action="append", default=[],
                    help="not on one card: no mesh to shard over")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() widths")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-hlo", default=None,
                    help="not in the port: eager PyTorch emits no HLO")
    args = ap.parse_args(argv)
    try:
        check_card_mesh(args.mesh, args.rule)
    except ValueError as err:
        ap.error(str(err))
    if args.save_hlo:
        ap.error("--save-hlo: the port runs eager PyTorch and emits no HLO")
    overrides = dict(s.split("=", 1) for s in args.set)
    res = run_cell(args.arch, args.shape, args.mesh, overrides,
                   reduced=args.reduced)
    js = json.dumps(res, indent=2, default=str)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
