"""Reading a ``torch.profiler`` trace of whole replays: device busy time
(the union of the device's kernel, copy and set intervals), the host's
launch calls, kernels grouped by the CUDA-graph launch that ran them,
the device ops that took most time and the idle gaps by what the host
was doing.

The profiler now and then drops the records of a few kernels of a graph
launch; a reader that needs a graph's kernels takes only the launches
that hold every kernel it expects (``full_units``).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch")
SHORT_GAP_US = 10.0     # a gap inside a graph replay's run of kernels


class TraceReading:
    """What the readers take from one profile: seconds, counts and
    names (events' times are in microseconds)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        host = [e for e in events if e.device_type == DeviceType.CPU]
        self.launches = sum(1 for e in host if e.name in LAUNCH_CALLS
                            or e.name.startswith("cudaLaunchKernelEx"))
        graph_ids = [e.id for e in host
                     if e.name.startswith("cudaGraphLaunch")]
        unit_of = {i: n for n, i in enumerate(graph_ids)}
        self.units: Dict[int, List[Tuple[str, float]]] = defaultdict(list)
        ops: Dict[str, float] = defaultdict(float)
        spans = []
        for e in dev:
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            ops[e.name] += (t1 - t0) / 1e6
            if e.id in unit_of:
                self.units[unit_of[e.id]].append((e.name, (t1 - t0) / 1e6))
        merged = _union(spans)
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self.device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        self.idle_gaps = _gaps(merged, host)

    def full_units(self, match: Callable[[str], bool], per_unit: int
                   ) -> List[float]:
        """Seconds of the matching kernels of each graph launch that
        holds exactly ``per_unit`` of them."""
        out = []
        for ks in self.units.values():
            hit = [s for name, s in ks if match(name)]
            if len(hit) == per_unit:
                out.append(sum(hit))
        return out


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _gaps(merged, host) -> List[Tuple[str, float]]:
    """Idle device time between busy intervals, summed by the innermost
    host op running when each gap began (a gap under SHORT_GAP_US inside
    a run of kernels is the device's own, named as such)."""
    if not merged:
        return []
    hs = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in host)
    starts = [h[0] for h in hs]
    out: Dict[str, float] = defaultdict(float)
    for (_, t0), (t1, _) in zip(merged, merged[1:]):
        gap = t1 - t0
        if gap < SHORT_GAP_US:
            out["device: between kernels (< 10 us)"] += gap / 1e6
            continue
        name = _innermost(hs, starts, t0)
        out[f"host: {name}"] += gap / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]


def _innermost(hs, starts, t: float) -> str:
    """The latest-starting host event that covers time ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, 0) - 1, -1):
        if hs[j][1] > t:
            return hs[j][2]
    return "python (no op)"
