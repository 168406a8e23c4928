"""Runner of the ``train`` mixes: training jobs run back to back through
the program's ``Trainer``, the way a user retrains the classifier for
each task and seed before quantizing it.

Set-up makes the mix's labelled windows and the configuration's float
initial weights from the seed, builds one ``Trainer`` (the program's
float model and loss, its AdamW, its step backend) and runs one whole
job (the first step captures the step graph).  The window then runs
jobs of ``job_steps`` steps: before each, the trainer's leaves are set
back to the initial weights and its moments and step counter to zero,
in place, so the captured step replays on the same buffers; the job's
rows come from ``Feed``.  A step is timed from its rows' draw until its
metrics are on the host; the reset between jobs is in the window but in
no step.  The window ends with the first job that ends ``seconds`` after
it began.  A traced run then runs one more job and profiles its last
``trace_steps`` steps.  Last, with the program's state freed, the plain
reference reruns the first steps of the window's last job from the same
weights over the same rows, and ``check_train`` decides ``correct``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check_train, inputs
from portbench.reference import train_ref
from portbench.runners.replay import _MODEL_KEYS, _power_limit
from portbench.tracing import TraceReading


@dataclasses.dataclass
class Job:
    seconds: float
    steps: List[float]               # each step's seconds
    losses: List[float]
    indices: List[np.ndarray]        # the rows of the first KEEP steps


@dataclasses.dataclass
class Context:
    """What a metric reader reads from one run."""
    config: Dict
    mix: Dict
    setup_s: float
    window_s: float
    window: List[Job]
    trace: Optional[TraceReading] = None
    traced_steps: int = 0
    device: Dict = dataclasses.field(default_factory=dict)
    breakdown: Optional[Dict] = None
    checks: Dict = dataclasses.field(default_factory=dict)
    limits: Dict = dataclasses.field(default_factory=dict)
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    reference_s: float = 0.0
    setup_parts: Dict = dataclasses.field(default_factory=dict)
    step_graphs: int = 0             # step graphs the jobs used

    @property
    def on_card(self) -> bool:
        return self.device.get("platform") == "gpu"

    @property
    def windows(self) -> int:
        """Windows trained in the window: its steps times the batch."""
        return sum(len(j.steps) for j in self.window) \
            * int(self.mix["batch"])


class Feed:
    """The batches of a job.  ``data`` (the training set on the device)
    is one dict for every job, so the trainer keeps its step buffers and
    graph; each step's rows are the next ``batch`` of a permutation of
    the set, drawn anew each epoch from ``default_rng([seed, job])``, so
    the rows of a step, and of an epoch, all differ."""

    def __init__(self, data: Dict[str, torch.Tensor], batch: int):
        self.data = data
        self.n = int(data["label"].shape[0])
        if batch > self.n:
            raise ValueError(f"batch {batch} > the {self.n} windows")
        self.batch = batch

    def start(self, seed: int, job: int) -> None:
        self._rng = np.random.default_rng([seed & inputs.SEED_MASK, job])
        self._perm, self._pos = None, self.n

    def __iter__(self) -> "Feed":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._pos + self.batch > self.n:
            self._perm, self._pos = self._rng.permutation(self.n), 0
        self._pos += self.batch
        return {"index": self._perm[self._pos - self.batch:self._pos]}


def build_trainer(cell, init: Dict[str, torch.Tensor], dev):
    """The program's ``Trainer`` of the float model on the mix's
    optimizer settings and step backend."""
    from repro_torch.configs.fenix_models import TrafficModelConfig
    from repro_torch.models import traffic
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg, mix = cell.config, cell.mix
    mcfg = TrafficModelConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                                 else cfg[k] for k in _MODEL_KEYS})
    steps = int(mix["job_steps"])
    opt = OptConfig(lr=float(mix["lr"]), b1=float(mix["b1"]),
                    b2=float(mix["b2"]), eps=float(mix["eps"]),
                    weight_decay=float(mix["weight_decay"]),
                    grad_clip=float(mix["grad_clip"]),
                    warmup_steps=int(mix["warmup_steps"]),
                    total_steps=steps, schedule=mix["schedule"])
    table = traffic.ipd_log2_table(dev)
    return Trainer(lambda p, b: traffic.loss_fn(p, mcfg, b, table), init,
                   TrainerConfig(total_steps=steps, log_every=10**9,
                                 step_backend=mix.get("step_backend"),
                                 opt=opt), device=dev)


class Snapshots:
    """Copies, on the device, of the trainer's first moments after a
    job's step 1 (``m1``) and of its leaves after step KEEP
    (``params_k``): each job writes them anew."""

    def __init__(self, trainer):
        self.names = list(trainer.params)
        self.params = [trainer.params[k] for k in self.names]
        self.m = [trainer.opt_state["m"][k] for k in self.names]
        self.v = [trainer.opt_state["v"][k] for k in self.names]
        self.m1 = [torch.empty_like(x) for x in self.m]
        self.params_k = [torch.empty_like(x) for x in self.params]

    def on_host(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: {n: t.to("cpu", copy=True)
                    for n, t in zip(self.names, getattr(self, k))}
                for k in ("m1", "params_k")}


def run_job(trainer, feed: Feed, snap: Snapshots, init: List[torch.Tensor],
            seed: int, job: int, prof=None, profile_last: int = 0) -> Job:
    """One job from the initial weights: reset in place, then
    ``job_steps`` steps, each timed from its rows' draw until its
    metrics are on the host.  With ``prof``, the last ``profile_last``
    steps run under it."""
    torch._foreach_copy_(snap.params, init)
    torch._foreach_zero_(snap.m + snap.v)
    trainer.opt_state["step"].zero_()
    trainer.step = 0
    feed.start(seed, job)
    steps = int(trainer.cfg.total_steps)
    rec = Job(0.0, [], [], [])
    t_job = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for s in range(steps):
            if prof is not None and s == steps - profile_last:
                stack.enter_context(prof)
            t0 = time.perf_counter()
            item = next(feed)
            metrics = trainer.train_step(feed, item)
            rec.steps.append(time.perf_counter() - t0)
            rec.losses.append(metrics["loss"])
            if np.isfinite(metrics["loss"]):
                trainer.step += 1
            if s < check_train.KEEP:
                rec.indices.append(item["index"])
            if s == 0:
                torch._foreach_copy_(snap.m1, snap.m)
            if s == check_train.KEEP - 1:
                torch._foreach_copy_(snap.params_k, snap.params)
    rec.seconds = time.perf_counter() - t_job
    return rec


class StepGraphs:
    """The step buffers and graphs the trainer held after each job,
    kept (so no two are told apart by a reused address) and counted: a
    new pair means the step was built, and on CUDA captured, anew."""

    def __init__(self):
        self.seen: List[tuple] = []

    def add(self, trainer) -> None:
        pair = (trainer._bufs, trainer._graph)
        if not any(a is pair[0] and b is pair[1] for a, b in self.seen):
            self.seen.append(pair)


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float
        ) -> Context:
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    mix = cell.mix
    marks = [("start", t_start), ("imports", time.perf_counter())]
    x, y, w = inputs.make_training_windows(mix, seed, cell.config["seq_len"])
    data = {"payload": x, "label": y, "weight": w}
    marks.append(("windows", time.perf_counter()))
    init = inputs.make_float_params(cell.config, seed, dev)
    init_cpu = {k: t.to("cpu", copy=True) for k, t in init.items()}
    marks.append(("weights", time.perf_counter()))
    trainer = build_trainer(cell, init, dev)
    feed = Feed({k: torch.from_numpy(a).to(dev) for k, a in data.items()},
                int(mix["batch"]))
    init_l = list(init.values())
    snap = Snapshots(trainer)
    marks.append(("trainer", time.perf_counter()))
    run_job(trainer, feed, snap, init_l, seed, 0)   # captures the step
    graphs = StepGraphs()
    graphs.add(trainer)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    window: List[Job] = []
    w0 = time.perf_counter()
    while True:
        window.append(run_job(trainer, feed, snap, init_l, seed,
                              len(window) + 1))
        graphs.add(trainer)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    ctx = Context(cell.config, mix, setup_s, window_s, window)
    ctx.setup_parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    if cuda:
        torch.cuda.synchronize(dev)
        ctx.device = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev),
                      "count": cell.chips,
                      "memory_peak_bytes": int(
                          torch.cuda.max_memory_allocated(dev))}
    last = window[-1]
    prog = {"losses": last.losses, **snap.on_host()}
    if trace:
        _traced(ctx, trainer, feed, snap, init_l, seed, len(window) + 1,
                cuda)
        graphs.add(trainer)
    ctx.step_graphs = len(graphs.seen)
    if ctx.step_graphs != 1:
        raise RuntimeError(f"the jobs built {ctx.step_graphs} step graphs; "
                           "one is captured in set-up and replayed after")
    if cuda:
        ctx.device["power_limit"] = _power_limit()
    del trainer, feed, snap, init, init_l, graphs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = train_ref.run_job(cell.config, mix, data, init_cpu,
                            last.indices[:check_train.KEEP], dev,
                            check_train.KEEP)
    ctx.reference_s = time.perf_counter() - t0
    nums = check_train.compare(prog, ref, init_cpu, float(mix["b1"]))
    ctx.checks, ctx.limits = nums, check_train.LIMITS
    ctx.correct = check_train.verdict_of(nums)
    losses = np.asarray([x for j in window for x in j.losses])
    ctx.attempted = len(losses)
    ctx.failed = int((~np.isfinite(losses)).sum())
    return ctx


def _traced(ctx: Context, trainer, feed: Feed, snap: Snapshots, init,
            seed: int, job: int, cuda: bool) -> None:
    """One more job, its last ``trace_steps`` steps under the profiler,
    read into ``ctx.trace``, the device's busy and window seconds and
    the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    n = int(ctx.mix["trace_steps"])
    prof = profile(activities=acts, acc_events=True)
    run_job(trainer, feed, snap, init, seed, job, prof, n)
    ctx.trace = TraceReading(prof)
    ctx.traced_steps = n
    steps = int(ctx.mix["job_steps"])
    # the traced steps' length as they run unprofiled: each step's
    # median over the window's jobs
    wall = float(sum(np.median([j.steps[s] for j in ctx.window])
                     for s in range(steps - n, steps)))
    if cuda and ctx.trace.busy_s > 0:
        ctx.device["busy_s"] = ctx.trace.busy_s
        ctx.device["window_s"] = wall
    ctx.breakdown = {"device_ops": [[k, v] for k, v in
                                    ctx.trace.device_ops],
                     "idle_gaps": [[k, v] for k, v in ctx.trace.idle_gaps]}
