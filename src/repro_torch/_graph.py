"""CUDA-graph capture of a compiled step: the port's counterpart of
``jax.jit``.

A step is a function ``fn(bufs)`` of a nested dict of tensors that reads
its inputs from ``bufs`` and leaves its results in the same tensors (its
carry, as the reference's donated carry).  :func:`capture` records one
call of it as a CUDA graph; :meth:`Graph.replay` runs the recorded
kernels again, unfused and in the same order, so every float32 rounding
of the eager step holds.  Nothing here compiles or fuses.

Before capture the step runs once on a side stream: that first run sets
every kernel's once-per-process attributes and the libraries' lazy state
outside the capture.  It runs on ``bufs`` themselves, except at the key
paths named ``scratch``, which it reads and writes on copies: the state
that the warm-up must not advance (a system's threefry key, bucket,
queues and delay line; a decode step's position and recurrent states);
its telemetry probes, if any, write the scratch record.  Its kernel
launches are not counted, and neither are those recorded during
capture; each replay counts the launches recorded at capture in the
kernel wrappers' ``launches``, so a replayed path reads the same counts
as the eager one.

A graph holds raw addresses.  The tensors the step reads outside
``bufs`` (model weights, tables) are named by ``reads``, a function that
returns them as they are now; the graph keeps those of capture alive and
refuses to replay once any of them has moved (a module's ``.to()``, a
weight reload): its owner captures again.  A capture that fails raises:
there is no eager fallback.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn

from repro_torch import _telemetry
from repro_torch._device import no_host_sync

Bufs = Dict[str, object]


def _counters() -> List:
    """The port's kernel wrappers, each counting its launches."""
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.int8_matmul.kernel import int8_gemm
    from repro_torch.kernels.rate_gate.kernel import (fused_gate,
                                                      fused_gate_prng,
                                                      rate_gate,
                                                      rate_gate_prng,
                                                      threefry_draw)

    return [fused_gate, fused_gate_prng, rate_gate, rate_gate_prng,
            threefry_draw, int8_gemm, decode_attention]


def clone(bufs):
    """A deep copy of a nested dict of tensors (other leaves shared)."""
    if isinstance(bufs, dict):
        return {k: clone(v) for k, v in bufs.items()}
    return bufs.clone() if isinstance(bufs, torch.Tensor) else bufs


def with_scratch(bufs: Bufs, paths: Iterable[Tuple[str, ...]]) -> Bufs:
    """``bufs`` with a copy at each key path of ``paths``; every other
    leaf is shared."""
    out = dict(bufs)
    for path in paths:
        d = out
        for k in path[:-1]:
            d[k] = dict(d[k])
            d = d[k]
        d[path[-1]] = clone(d[path[-1]])
    return out


def tensors_of(*objs) -> List[torch.Tensor]:
    """The tensors of ``objs``: a module's parameters and buffers, a
    dict's tensor values, a tensor itself (other objects hold none)."""
    out: List[torch.Tensor] = []
    for o in objs:
        if isinstance(o, nn.Module):
            out += [*o.parameters(), *o.buffers()]
        elif isinstance(o, dict):
            out += [v for v in o.values() if isinstance(v, torch.Tensor)]
        elif isinstance(o, torch.Tensor):
            out.append(o)
    return out


def _addresses(ts: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in ts)


class Graph:
    """A captured step: ``replay()`` runs it on the buffers it was
    captured on.  ``launches`` maps each kernel wrapper to the launches
    one replay makes; ``seconds`` is the warm-up and capture time."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict,
                 seconds: float, reads: Callable[[], List[torch.Tensor]]):
        self.graph = graph
        self.launches = launches
        self.seconds = seconds
        self._reads = reads
        self._held = reads()          # alive while the graph may replay
        self._addr = _addresses(self._held)

    def stale(self) -> bool:
        """Whether a tensor the step reads outside its buffers has moved
        since capture."""
        return _addresses(self._reads()) != self._addr

    def replay(self) -> None:
        if self.stale():
            raise RuntimeError("a tensor the captured step reads moved "
                               "after capture (.to(), a reload): capture "
                               "the step again")
        self.graph.replay()
        for kernel, n in self.launches.items():
            kernel.launches += n


def capture(fn: Callable[[Bufs], None], bufs: Bufs, device: torch.device,
            pool=None, scratch: Iterable[Tuple[str, ...]] = (),
            reads: Callable[[], List[torch.Tensor]] = list) -> Graph:
    """Warm ``fn`` up on ``bufs`` (with copies at the key paths
    ``scratch``) on a side stream, then capture ``fn(bufs)`` into a graph
    in memory pool ``pool`` (a ``torch.cuda.graph_pool_handle()`` shared
    by the graphs of one owner).  ``bufs`` must keep their addresses for
    as long as the graph is replayed; ``reads()`` returns the tensors the
    step reads outside them (the graph replays only while those keep
    theirs)."""
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device; got {device}")
    counters = _counters()
    before = [k.launches for k in counters]
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), no_host_sync(device), \
            _telemetry.aside():
        fn(with_scratch(bufs, scratch))
    torch.cuda.current_stream(device).wait_stream(side)
    for k, n in zip(counters, before):
        k.launches = n
    graph = torch.cuda.CUDAGraph()
    # a graph that the garbage collector destroys during the capture
    # (one held in a reference cycle) would invalidate it
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            fn(bufs)
    finally:
        if was_enabled:
            gc.enable()
    launches = {k: k.launches - n for k, n in zip(counters, before)
                if k.launches != n}
    for k, n in zip(counters, before):
        k.launches = n
    torch.cuda.synchronize(device)
    return Graph(graph, launches, time.perf_counter() - t0, reads)
