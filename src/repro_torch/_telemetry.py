"""The replay's telemetry: host spans, counters and device probes.

Off by default.  ``enabled()`` turns it on for a block; ``drain()``
returns what it recorded and clears it.  It is the port's one tracing
system, and copies no counter the program keeps elsewhere.

**Host spans.**  ``span(name)`` is a context manager at a layer boundary
of a replay (``SPANS``).  Off, with no ``torch.profiler`` session
running, it returns a shared no-op.  Under a profiler session it opens
a host op ``fenix.<name>`` (a record function of function scope), so the
span sits in the profiler's host timeline and names the device's idle
gaps there.  On, it records
the span's name, parent and start and end (``time.perf_counter_ns``) in
the replay's record.  A replay's record opens at ``reset()`` or, without
one since the last replay, at ``run_trace``; its root span ``replay``
closes when ``run_trace`` returns.  The last ``HISTORY`` replays are
kept.

**Counters**, a replay's each (``COUNTERS``): full chunks (lockstep
steps on the pipes and farm drivers) and eager tail steps, the per-step
readings' denominator, and graph captures (none once both sets of chunk
graphs exist).

**Device probes** (``csrc/telemetry.cu``): a one-thread kernel that
reads the card's ``%globaltimer`` into a small int64 record on the
device, with no host sync.  ``open_device`` starts a device span
(adding the idle time since the last span's end to the record's gap),
``mark`` ends a stage of a chunk's work (``STAGES``) where the step's
code writes it, ``close_device`` ends the span's last stage.  Marks
take effect only inside an open device span or a ``capturing()`` block,
so they are captured into a chunk graph only when it is captured with
telemetry on: the system keeps those graphs apart from the ones it
replays with telemetry off.  Every host span that enqueues device work
of its own is a device span too, so the gap holds idle time alone.
The record is zeroed when a replay's record opens and read by the
replay's one host wait.  On the CPU the probes do nothing, and a replay
has no device reading.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled

# host spans: the root of a replay, then the ones below it
SPANS = ("replay", "reset", "stage", "load_bufs", "enqueue", "finish")
# the stages of a chunk's device time, in the order the step runs them
STAGES = ("deliver", "flow", "draw", "gate", "table", "enqueue_ring",
          "dequeue", "infer", "push", "control_plane", "store")
# the record's slots: a chunk's stages, then the host spans that enqueue
# device work of their own
SLOTS = STAGES + ("reset", "stage", "load_bufs", "finish")
COUNTERS = ("chunks", "tail_steps", "graph_captures")
HISTORY = 1024

_OPEN, _MARK, _CLOSE = 0, 1, 2
_SLOT = {name: k for k, name in enumerate(SLOTS)}
_WORDS = 4 + 2 * len(SLOTS)
_NOOP = contextlib.nullcontext()


class _Recorder:
    """The module's state: whether telemetry is on, the replay being
    recorded, its open spans, whether a device span is open (marks are
    live), whether probes go to the scratch record (a capture's warm-up),
    the finished replays and the device records."""

    def __init__(self):
        self.on = False
        self.cur: Optional[Dict] = None
        self.stack: List[int] = []
        self.in_device = False
        self.aside = False
        self.done: collections.deque = collections.deque(maxlen=HISTORY)
        self.ids = itertools.count()
        self.records: Dict[int, torch.Tensor] = {}


_r = _Recorder()


def active() -> bool:
    """Whether telemetry is on."""
    return _r.on


@contextlib.contextmanager
def enabled():
    """Telemetry on for the block (a replay left open at its end is
    dropped)."""
    prev = _r.on
    _r.on = True
    try:
        yield
    finally:
        _r.on = prev
        if not prev:
            _r.cur, _r.stack, _r.in_device = None, [], False


def drain() -> List[Dict]:
    """The finished replays' readings, oldest first; clears them.  Each
    is a dict: ``id``, ``driver``, ``spans`` (name, parent index or None,
    start_ns, end_ns; the root first), ``counters`` (``COUNTERS``) and
    ``device`` (None off the card, else ``ns`` and ``marks`` by slot,
    ``gap_ns`` and ``spans``)."""
    out = list(_r.done)
    _r.done.clear()
    return out


def _profiled(name: str):
    # a host op of the profiler's timeline; a user-scope record_function
    # would also draw a device-side range over the span's kernels, which
    # the profiler reports as device time
    return torch._C._profiler._RecordFunctionFast(f"fenix.{name}")


def _now() -> int:
    return time.perf_counter_ns()


def _record(device: torch.device) -> torch.Tensor:
    """The device's [2, words] record: row 0 the replay's, row 1 the
    scratch a capture's warm-up writes."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    rec = _r.records.get(idx)
    if rec is None:
        rec = torch.zeros((2, _WORDS), dtype=torch.int64,
                          device=torch.device("cuda", idx))
        _r.records[idx] = rec
    return rec


def _start(device: Optional[torch.device]) -> None:
    """Open a replay's record (dropping one that never ran) and zero the
    device record."""
    _r.cur = {"id": next(_r.ids), "driver": None, "running": False,
              "spans": [{"name": "replay", "parent": None,
                         "start_ns": _now(), "end_ns": None}],
              "counters": dict.fromkeys(COUNTERS, 0), "device": None}
    _r.stack = [0]
    _r.in_device = False
    if device is not None and device.type == "cuda":
        _record(device)[0].zero_()


class _Span:
    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device
        self.idx: Optional[int] = None
        self.prof = None

    def __enter__(self):
        if self.name == "reset" and (_r.cur is None
                                     or not _r.cur["running"]):
            _start(self.device)
        if _profiler_enabled():
            self.prof = _profiled(self.name)
            self.prof.__enter__()
        cur = _r.cur
        if cur is None:
            return self
        self.idx = len(cur["spans"])
        cur["spans"].append({"name": self.name, "parent": _r.stack[-1],
                             "start_ns": _now(), "end_ns": None})
        _r.stack.append(self.idx)
        if self.device is not None:
            open_device(self.device)
        return self

    def __exit__(self, *exc):
        if self.idx is not None and _r.cur is not None:
            if self.device is not None:
                close_device(self.name, self.device)
            _r.cur["spans"][self.idx]["end_ns"] = _now()
            _r.stack.pop()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


class _Replay:
    def __init__(self, device: torch.device, driver: str):
        self.device, self.driver = device, driver
        self.prof = None

    def __enter__(self):
        if _r.cur is None or _r.cur["running"]:
            _start(self.device)
        _r.cur["running"] = True
        _r.cur["driver"] = self.driver
        if _profiler_enabled():
            self.prof = _profiled("replay")
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        cur = _r.cur
        if cur is not None:
            cur["spans"][0]["end_ns"] = _now()
            del cur["running"]
            _r.done.append(cur)
        _r.cur, _r.stack, _r.in_device = None, [], False
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A host span of the replay being recorded (``SPANS``); with a CUDA
    ``device`` it is also a device span of slot ``name``.  ``reset``
    opens a replay's record when none is running."""
    if not _r.on:
        return _profiled(name) if _profiler_enabled() else _NOOP
    return _Span(name, device)


def replay(device: torch.device, driver: str):
    """The root span of one ``run_trace`` on ``driver``."""
    if not _r.on:
        return _profiled("replay") if _profiler_enabled() else _NOOP
    return _Replay(device, driver)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the replay's counter ``name``."""
    if _r.cur is not None:
        _r.cur["counters"][name] += n


@contextlib.contextmanager
def capturing():
    """The step's marks in the block are live with no probe of their
    own, inside a replay being recorded: a chunk graph captured in it
    holds them."""
    prev = _r.in_device
    _r.in_device = _r.cur is not None
    try:
        yield
    finally:
        _r.in_device = prev


@contextlib.contextmanager
def aside():
    """Probes of the block write the scratch record (a capture's warm-up
    runs the step once more than the replay does)."""
    prev = _r.aside
    _r.aside = True
    try:
        yield
    finally:
        _r.aside = prev


def _probe(where, op: int, k: int) -> None:
    """Launch one probe on the current stream of ``where``'s device (a
    tensor or a device); nothing off CUDA."""
    device = where.device if isinstance(where, torch.Tensor) \
        else torch.device(where)
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build

    ptr = _record(device).data_ptr() + (8 * _WORDS if _r.aside else 0)
    fn = _build.function("fenix_probe_launch",
                         (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p))
    _build.check(fn(ptr, op, k, len(SLOTS),
                    torch.cuda.current_stream(device).cuda_stream),
                 "fenix_probe")


def open_device(device) -> None:
    """Open a device span (only inside a replay being recorded)."""
    if _r.cur is None or _r.in_device:
        return
    _r.in_device = True
    _probe(device, _OPEN, 0)


def mark(stage: str, where) -> None:
    """End stage ``stage`` of the work enqueued since the last probe."""
    if not _r.in_device:
        return
    _probe(where, _MARK, _SLOT[stage])


def close_device(slot: str, device) -> None:
    """End the open device span, its last work going to ``slot``."""
    if not _r.in_device:
        return
    _r.in_device = False
    _probe(device, _CLOSE, _SLOT[slot])


def collect(device: torch.device) -> None:
    """Read the device record into the replay's (a host wait: called
    where the replay already waits for its results)."""
    if _r.cur is None or device.type != "cuda":
        return
    rec = _record(device)[0].cpu().tolist()
    n = len(SLOTS)
    _r.cur["device"] = {
        "ns": dict(zip(SLOTS, rec[4:4 + n])),
        "marks": dict(zip(SLOTS, rec[4 + n:4 + 2 * n])),
        "gap_ns": rec[2], "spans": rec[3]}
