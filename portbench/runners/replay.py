"""Runner of the ``replay`` mixes: captures replayed back to back through
``FenixSystem.run_trace``, one client in a closed loop.

Set-up makes the mix's captures and the configuration's weights from
the seed, builds the system on the mix's driver and replays every
capture once (the first replay captures the step graphs; the rest meet
every shape the window will).  The window then replays the captures in
turn, each from a fresh state: a replay is timed from before
``reset()`` until its verdicts are on the host.  It ends with the first
replay that ends ``seconds`` after the window began.  A traced run then
replays ``trace_replays`` captures under ``torch.profiler``.  Last, with
the program's state freed, the plain reference replays each capture the
window replayed, on the same weights, and the comparison decides
``correct``.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import check, inputs
from portbench.reference import fenix_ref
from portbench.reference.model_ref import ModelRef
from portbench.tracing import TraceReading

_MODEL_KEYS = ("name", "kind", "num_classes", "seq_len", "len_buckets",
               "ipd_buckets", "embed_dim", "conv_filters", "conv_kernel",
               "fc_dims", "rnn_units", "quant_bits")


@dataclasses.dataclass
class Replay:
    capture: int
    seconds: float
    packets: int
    inferences: int
    digest: Tuple[int, str]


@dataclasses.dataclass
class Context:
    """What a metric reader reads from one run."""
    config: Dict
    mix: Dict
    setup_s: float
    window_s: float
    window: List[Replay]
    steps: List[int]                 # steps a replay, by capture
    trace: Optional[TraceReading] = None
    traced: List[Replay] = dataclasses.field(default_factory=list)
    device: Dict = dataclasses.field(default_factory=dict)
    breakdown: Optional[Dict] = None
    checks: Dict = dataclasses.field(default_factory=dict)
    limits: Dict = dataclasses.field(default_factory=dict)
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    reference_s: float = 0.0
    setup_parts: Dict = dataclasses.field(default_factory=dict)

    @property
    def on_card(self) -> bool:
        return self.device.get("platform") == "gpu"

    @property
    def traced_steps(self) -> int:
        """Steps (lockstep steps and a tail round) the traced replays
        ran."""
        return sum(self.steps[r.capture] for r in self.traced)

    def unprofiled_s(self, capture: int) -> Optional[float]:
        """The median window time of a capture's replays."""
        t = [r.seconds for r in self.window if r.capture == capture]
        return float(np.median(t)) if t else None


def build_system(cell, qp: Dict, dev):
    """The system under test on the mix's driver and backends."""
    from repro_torch.configs.fenix_models import TrafficModelConfig
    from repro_torch.core.fenix import FenixConfig, FenixSystem
    from repro_torch.core.model_engine.inference import EngineModel
    from repro_torch.core.model_engine.serving import qparams_from_numpy

    cfg, mix = cell.config, cell.mix
    mcfg = TrafficModelConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                                 else cfg[k] for k in _MODEL_KEYS})
    model = EngineModel(mcfg, qparams_from_numpy(qp, dev),
                        backend=mix.get("matmul_backend"))
    fcfg = FenixConfig(model=f"int8_{cfg['kind']}",
                       batch_size=int(mix["batch_size"]),
                       control_plane_every=int(mix["control_plane_every"]),
                       driver=mix["driver"],
                       num_pipes=int(mix.get("num_pipes", 1)),
                       num_engines=int(mix.get("num_engines", 1)),
                       gate_backend=mix.get("gate_backend"),
                       matmul_backend=mix.get("matmul_backend"),
                       step_backend=mix.get("step_backend"))
    return FenixSystem(fcfg, model, device=dev)


def replay_once(system, stream) -> Tuple[np.ndarray, float]:
    t0 = time.perf_counter()
    system.reset()
    verdict = system.run_trace(stream)["verdict"]
    return verdict, time.perf_counter() - t0


def final_carry(system) -> Dict[str, Dict[str, torch.Tensor]]:
    """The carry the run ended with, stacked by pipe as the reference
    holds it (one pipe on the device driver)."""
    if system.cfg.driver in ("pipes", "farm"):
        groups = {"state": system.pstate, "queues": system.pqueues,
                  "dl": system.pdl}
        if system.cfg.driver == "farm":
            groups["eq"] = system.eq
    else:
        groups = {"state": {k: v[None] for k, v in system.state.items()},
                  "queues": {k: v[None] for k, v in system.queues.items()}}
    return {g: {k: v.detach().cpu() for k, v in t.items()}
            for g, t in groups.items()}


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float
        ) -> Context:
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    mix = cell.mix
    marks = [("start", t_start), ("imports", time.perf_counter())]
    caps = inputs.make_captures(mix, seed)
    streams = [inputs.stream_of(c) for c in caps]
    marks.append(("captures", time.perf_counter()))
    qp = inputs.make_weights(cell.config, seed, caps[0]["windows"], dev)
    marks.append(("weights", time.perf_counter()))
    del caps
    lay = fenix_ref.layout_of(mix)
    steps = []
    for s in streams:
        n_steps, tails = fenix_ref.steps_of(s, lay)
        steps.append(n_steps + (1 if tails else 0))
    system = build_system(cell, qp, dev)
    marks.append(("system", time.perf_counter()))
    for s in streams:                   # warm-up: every capture once
        replay_once(system, s)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    last: Dict[int, Tuple[np.ndarray, Dict]] = {}

    def one(k: int) -> Replay:
        v, sec = replay_once(system, streams[k])
        st = system.stats
        last[k] = (v, st)
        return Replay(k, sec, len(v), st["inferences"], check.digest(v, st))

    window: List[Replay] = []
    w0 = time.perf_counter()
    while True:
        window.append(one(len(window) % len(streams)))
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    ctx = Context(cell.config, mix, setup_s, window_s, window, steps)
    ctx.setup_parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    k_last = window[-1].capture
    if cuda:
        torch.cuda.synchronize(dev)
        ctx.device = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev),
                      "count": cell.chips,
                      "memory_peak_bytes": int(
                          torch.cuda.max_memory_allocated(dev))}
    if trace:
        _traced(ctx, one, len(streams), cuda)
        k_last = ctx.traced[-1].capture
    carry = (k_last, final_carry(system))
    if cuda:
        ctx.device["power_limit"] = _power_limit()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = ModelRef(cell.config, qp, dev)
    refs = {k: fenix_ref.replay(streams[k], lay, model, dev) for k in last}
    ctx.reference_s = time.perf_counter() - t0
    digests = [(r.capture, r.digest) for r in window + ctx.traced]
    nums, bad = check.compare(last, digests, carry, refs)
    ctx.checks, ctx.limits = nums, check.LIMITS
    ctx.correct = check.verdict_of(nums)
    ctx.attempted = len(window)
    ctx.failed = sum(bad[:len(window)])
    return ctx


def _traced(ctx: Context, one, n_caps: int, cuda: bool) -> None:
    """``trace_replays`` replays under the profiler (captures in turn),
    read into ``ctx.trace``, the device's busy and window seconds and
    the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    n = int(ctx.mix.get("trace_replays", 1))
    with profile(activities=acts, acc_events=True) as prof:
        ctx.traced = [one(j % n_caps) for j in range(n)]
    ctx.trace = TraceReading(prof)
    walls = [ctx.unprofiled_s(r.capture) for r in ctx.traced]
    if cuda and ctx.trace.busy_s > 0 and None not in walls:
        # the traced replays' length as they run unprofiled: the
        # profiler stretches a replay's wall, not its device work
        ctx.device["busy_s"] = ctx.trace.busy_s
        ctx.device["window_s"] = float(sum(walls))
    ctx.breakdown = {"device_ops": [[k, v] for k, v in
                                    ctx.trace.device_ops],
                     "idle_gaps": [[k, v] for k, v in ctx.trace.idle_gaps]}
