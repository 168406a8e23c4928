"""The program's own readings of a traced run: the replay telemetry of
``repro_torch._telemetry`` (host spans, counters, and device probes that
split each chunk's device time by stage), read by the per-layer metrics
``flow_ms_per_step`` and the others of the same family.

The first such reader runs the telemetry pass once and keeps it on the
context (``ctx.telemetry``): the run's captures and weights are made
again from its ``--seed``, a system is built on the cell's driver, each
capture is replayed once with telemetry on (capturing the graphs that
hold the probes; not read), then ``trace_replays`` more replays,
captures in turn, are drained into ``ctx.telemetry``.  Each replay's
verdicts and stats must be the window's for its capture, or the pass
raises.  The window, the profiled replays and the comparison that
decides ``correct`` have run before, with telemetry off, and are not
touched.  A program without the telemetry (no ``repro_torch._telemetry``)
gives no reading, and each reader then returns None.  On the card the
pass needs ``--seed`` on the run's command line, as ``run.py`` has it,
and raises without it.

"Per step" counts a replay's full chunks and, when it has any, its round
of eager tail steps as one more, as the runner's ``steps`` do.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import sys
import types
from typing import Iterable, List, Optional

import numpy as np

_UNREAD = object()


def _seed() -> Optional[int]:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _telemetry_pass(ctx) -> Optional[List[dict]]:
    import torch

    if importlib.util.find_spec("repro_torch._telemetry") is None:
        return None
    seed = _seed()
    if seed is None:
        raise RuntimeError("the telemetry pass makes the run's captures "
                           "again from --seed, which the command line "
                           "lacks")
    from repro_torch import _telemetry as tm

    from portbench import check, inputs
    from portbench.runners import replay

    dev = torch.device("cuda", 0)
    caps = inputs.make_captures(ctx.mix, seed)
    streams = [inputs.stream_of(c) for c in caps]
    qp = inputs.make_weights(ctx.config, seed, caps[0]["windows"], dev)
    del caps
    cell = types.SimpleNamespace(config=ctx.config, mix=ctx.mix)
    system = replay.build_system(cell, qp, dev)
    want = {r.capture: r.digest for r in ctx.window}
    n = int(ctx.mix.get("trace_replays", 1))
    with tm.enabled():
        for s in streams:
            replay.replay_once(system, s)
        tm.drain()
        for j in range(n):
            k = j % len(streams)
            verdict, _ = replay.replay_once(system, streams[k])
            if k in want and check.digest(verdict, system.stats) != want[k]:
                raise RuntimeError(f"a telemetry replay of capture {k} "
                                   "differs from the window's")
        out = tm.drain()
    del system
    gc.collect()
    torch.cuda.empty_cache()
    _print(out)
    return out


def reading(ctx) -> Optional[List[dict]]:
    """The telemetry replays with a device reading, or None (off the
    card, or a program without telemetry)."""
    if not ctx.on_card:
        return None
    got = getattr(ctx, "telemetry", _UNREAD)
    if got is _UNREAD:
        got = _telemetry_pass(ctx)
        ctx.telemetry = got
    got = [r for r in got or () if r.get("device")]
    return got or None


def steps_of(r: dict) -> int:
    c = r["counters"]
    return c["chunks"] + (1 if c["tail_steps"] else 0)


def per_step_ms(ctx, slots: Iterable[str]) -> Optional[float]:
    """The device ms a step of the stages ``slots``, summed."""
    rs = reading(ctx)
    if rs is None:
        return None
    steps = sum(steps_of(r) for r in rs)
    if not steps:
        return None
    ns = sum(r["device"]["ns"][s] for r in rs for s in slots)
    return ns / steps / 1e6


def span_ms(r: dict, name: str) -> float:
    """Host ms of the replay's spans ``name``, summed."""
    return sum(s["end_ns"] - s["start_ns"] for s in r["spans"]
               if s["name"] == name) / 1e6


def per_replay_ms(ctx, of) -> Optional[float]:
    """The mean over the telemetry replays of ``of(replay)`` (ms)."""
    rs = reading(ctx)
    if rs is None:
        return None
    return float(np.mean([of(r) for r in rs]))


def _print(rs: List[dict]) -> None:
    """The whole split on stderr: each slot's device ms a step, the gap
    and the wall a replay."""
    rs = [r for r in rs if r.get("device")]
    steps = sum(steps_of(r) for r in rs)
    if not rs or not steps:
        return
    slots = rs[0]["device"]["ns"]
    split = {s: round(sum(r["device"]["ns"][s] for r in rs) / steps / 1e6,
                      5) for s in slots}
    walls = [span_ms(r, "replay") for r in rs]
    gaps = [r["device"]["gap_ns"] / 1e6 for r in rs]
    print(f"portbench: telemetry of {len(rs)} replays ({steps} steps): "
          f"device ms a step {split}; gap ms a replay "
          f"{[round(g, 4) for g in gaps]}; wall ms a replay "
          f"{[round(w, 4) for w in walls]}", file=sys.stderr)
