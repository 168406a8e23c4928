"""Fault-tolerant training loop.

Port of ``repro/train/trainer.py``, used by the FENIX traffic
classifiers (``serving.train_quantized``) and by the LM training
launcher (``launch/train.py``, which drives ``train_step`` itself).
Features, as the reference's:

  - AdamW + cosine schedule (train/optimizer.py)
  - checkpoint/restart: atomic npz, auto-resume from ``ckpt_dir``
  - failure handling: a NaN/inf loss restores the last checkpoint, or
    skips the batch when there is none
  - straggler mitigation hook: per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are counted
  - optional int8 gradient compression with error feedback
    (distributed/compression.py) before the optimizer update

The compiled step.  The reference jits the step with its params, moments
and compression state donated; the port runs one in-place step body
(``step_backend``): forward, ``torch.autograd.grad``, the optional
compression, clip and the AdamW update written into the params, moments,
counter and error-feedback buffers.  On CUDA the body is captured once
as a CUDA graph (``"graph"``, the default there) and replayed each step;
the CPU runs it eagerly (``"eager"``, its default; ``"graph"`` there
raises).  The update lands only where the loss is finite: it is selected
on the device (``torch.where`` over every buffer), so a NaN step leaves
the state as it was and the host only decides whether to restore a
checkpoint.  Each step reads its metrics back once (the reference's
``float(metrics["loss"])``).

Batches.  ``batch_iterator`` stages the windows, labels and weights on
the device once and yields only each batch's drawn indices (the
reference's draws from ``default_rng(seed)``), which a step copies into a
fixed buffer through pinned host memory; the step gathers its rows on
the device.  Any other iterator of dicts of arrays works too: each batch
is copied into fixed buffers of its shapes (a new shape captures anew).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import _graph
from repro_torch._device import (DeviceLike, resolve_device,
                                 resolve_step_backend, validate_backend)
from repro_torch.distributed.compression import (CompressedState,
                                                 compress_decompress)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_state, value_and_grad)

F32 = torch.float32


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 500
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 50
    straggler_factor: float = 3.0
    grad_compression: bool = False
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    # how the step runs: "graph" (a CUDA graph, the default on CUDA) |
    # "eager" (the default on the CPU)
    step_backend: Optional[str] = None

    def __post_init__(self):
        validate_backend(self.step_backend, "step_backend")


class Batches:
    """Endless batches of ``batch`` rows drawn with replacement, as the
    reference's ``batch_iterator`` draws them.  ``data`` holds the
    payloads, labels and (float32) weights on the device; ``next`` returns
    ``{"index": int64 [batch]}`` (a numpy draw) and the step gathers the
    rows."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int,
                 seed: int = 0, weights: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.data = {"payload": torch.as_tensor(np.asarray(x)).to(dev),
                     "label": torch.as_tensor(np.asarray(y)).to(dev)}
        if weights is not None:
            self.data["weight"] = torch.as_tensor(
                np.asarray(weights, np.float32)).to(dev)
        self.batch = batch
        self._n = len(y)
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> "Batches":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return {"index": self._rng.integers(0, self._n, self.batch)}


def batch_iterator(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0,
                   weights: Optional[np.ndarray] = None,
                   device: DeviceLike = None) -> Batches:
    """The training windows staged on ``device`` (``cuda`` unless the
    caller names another) and the reference's batches drawn from them."""
    return Batches(x, y, batch, seed=seed, weights=weights, device=device)


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.array(v))


def _copy_into(dst: Dict, src: Dict, where: str) -> None:
    """Copy a tree of arrays into the same tree of tensors, in place."""
    if sorted(dst) != sorted(src):
        raise ValueError(f"{where}: keys {sorted(src)} do not match "
                         f"{sorted(dst)}")
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_into(d, src[k], f"{where}/{k}")
        else:
            d.copy_(_tensor(src[k]))


def _select(ok: torch.Tensor, dst: Dict[str, torch.Tensor],
            new: Dict[str, torch.Tensor]) -> None:
    """dst[k] <- new[k] where ``ok`` (a 0-d bool on the device)."""
    for k, d in dst.items():
        d.copy_(torch.where(ok, new[k], d))


class Trainer:
    """Trains ``params`` (a flat dict of tensors or arrays, copied onto
    ``device``; ``cuda`` unless the caller names another) with
    ``loss_fn(params, batch) -> (loss, metrics)``.  ``params`` and
    ``opt_state`` are the step's own buffers: each step writes them in
    place."""

    def __init__(self, loss_fn: Callable, params: Dict[str, Any],
                 cfg: TrainerConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_backend = resolve_step_backend(cfg.step_backend,
                                                 self.device)
        self.params = {k: _tensor(v).detach().to(self.device).clone()
                       for k, v in params.items()}
        self.opt_state = init_state(self.params)
        self.step = 0
        self.loss_fn = loss_fn
        self.metrics_log: list = []
        self.straggler_steps = 0
        self.recoveries = 0
        self.comp_state = (CompressedState.init(self.params)
                           if cfg.grad_compression else None)
        # the step's buffers (built for the first batch of a source), its
        # graph, the names of the metrics it returns, pinned host staging
        # of a batch, and the capture seconds so far
        self._bufs: Optional[Dict] = None
        self._graph: Optional[_graph.Graph] = None
        self._names: List[str] = []
        self._pinned: Dict[str, torch.Tensor] = {}
        self.capture_s = 0.0
        if cfg.ckpt_dir:
            restored = ckpt_lib.restore_latest(cfg.ckpt_dir)
            if restored is not None:
                self._restore(*restored)

    def _restore(self, state: Dict, meta: Dict) -> None:
        """Copy a checkpoint into the step's buffers (in place, so a
        captured step replays on them)."""
        _copy_into(self.params, state["params"], "params")
        _copy_into(self.opt_state, state["opt"], "opt")
        self.step = int(meta["step"])

    # -- the step --------------------------------------------------------

    def _body(self, bufs: Dict) -> torch.Tensor:
        """One training step on ``bufs``, in place; returns the metrics
        [acc..., grad_norm, lr, loss] as one float32 vector."""
        params, opt, batch = bufs["params"], bufs["opt"], bufs["batch"]
        if "data" in bufs:
            batch = {k: v.index_select(0, batch["index"])
                     for k, v in bufs["data"].items()}
        loss, aux, grads = value_and_grad(self.loss_fn, params, batch)
        with torch.no_grad():
            comp = bufs.get("comp")
            if comp is not None:
                grads, new_comp = compress_decompress(
                    grads, CompressedState(comp))
            new_p, new_opt, om = apply_updates(params, grads, opt,
                                               self.cfg.opt)
            # the update lands only where the loss is finite: a NaN step
            # leaves every buffer as it was
            ok = torch.isfinite(loss)
            _select(ok, params, new_p)
            _select(ok, opt["m"], new_opt["m"])
            _select(ok, opt["v"], new_opt["v"])
            opt["step"].copy_(torch.where(ok, new_opt["step"], opt["step"]))
            if comp is not None:
                _select(ok, comp, new_comp.error)
            metrics = {**aux, **om, "loss": loss}
            self._names = list(metrics)
            return torch.stack([v.to(F32) for v in metrics.values()])

    def _capture_body(self, bufs: Dict) -> None:
        bufs["metrics"] = self._body(bufs)

    def _fits(self, data, item: Dict[str, torch.Tensor]) -> bool:
        """Whether the step's buffers take ``item`` from ``data``."""
        bufs = self._bufs
        return (bufs is not None and bufs.get("data") is data
                and sorted(bufs["batch"]) == sorted(item)
                and all(v.shape == bufs["batch"][k].shape
                        and v.dtype == bufs["batch"][k].dtype
                        for k, v in item.items()))

    def _buffers(self, batches: Iterator, item: Dict) -> Dict:
        """The step's buffers, with ``item`` copied into its batch
        buffers; new buffers (and no graph, as a new shape retraces the
        reference's jit) for a new batch source or batch shape."""
        data = getattr(batches, "data", None)
        item = {k: _tensor(v) for k, v in item.items()}
        if not self._fits(data, item):
            batch = {k: torch.empty_like(v, device=self.device)
                     for k, v in item.items()}
            self._bufs = {"params": self.params, "opt": self.opt_state,
                          "batch": batch}
            if data is not None:
                for k, v in data.items():
                    if v.device.type != self.device.type:
                        raise ValueError(
                            f"batches staged on {v.device}; the trainer "
                            f"runs on {self.device}")
                self._bufs["data"] = data
            if self.comp_state is not None:
                self._bufs["comp"] = self.comp_state.error
            self._pinned = ({k: torch.empty_like(v, device="cpu")
                             .pin_memory() for k, v in batch.items()}
                            if self.device.type == "cuda" else {})
            self._graph = None
        for k, dst in self._bufs["batch"].items():
            src = item[k]
            if k in self._pinned:
                # the previous step's metrics read has waited for the copy
                # out of this pinned buffer, so it may be written again
                self._pinned[k].copy_(src)
                dst.copy_(self._pinned[k], non_blocking=True)
            else:
                dst.copy_(src)
        return self._bufs

    def _train_step(self, batches: Iterator, item: Dict) -> torch.Tensor:
        bufs = self._buffers(batches, item)
        if self.step_backend == "eager":
            return self._body(bufs)
        if self._graph is None:
            scratch = [("params",), ("opt",)]
            if "comp" in bufs:
                scratch.append(("comp",))
            self._graph = _graph.capture(self._capture_body, bufs,
                                         self.device, scratch=scratch)
            self.capture_s += self._graph.seconds
        self._graph.replay()
        return bufs["metrics"]

    def train_step(self, batches: Iterator, item: Dict) -> Dict[str, float]:
        """One step on ``item`` (a batch of ``batches``) and its metrics,
        read back once.  A NaN step leaves the state as it was; the
        caller decides what to do with its metrics."""
        values = self._train_step(batches, item).tolist()  # one read
        return dict(zip(self._names, values))

    # -- the loop --------------------------------------------------------

    def run(self, batches: Iterator[Dict[str, Any]],
            steps: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        target = self.step + (steps or cfg.total_steps)
        ema = None
        last_metrics: Dict[str, float] = {}
        while self.step < target:
            item = next(batches)
            t0 = time.perf_counter()
            metrics = self.train_step(batches, item)
            dt = time.perf_counter() - t0
            if not math.isfinite(metrics["loss"]):
                # failure path: the step left the state as it was; restore
                # the last checkpoint, or skip the batch
                self.recoveries += 1
                if cfg.ckpt_dir:
                    restored = ckpt_lib.restore_latest(cfg.ckpt_dir)
                    if restored is not None:
                        self._restore(*restored)
                continue
            self.step += 1
            last_metrics = metrics
            if ema is None:
                ema = dt
            elif dt > cfg.straggler_factor * ema:
                self.straggler_steps += 1
                ema = 0.9 * ema + 0.1 * dt
            else:
                ema = 0.9 * ema + 0.1 * dt
            if self.step % cfg.log_every == 0:
                self.metrics_log.append({"step": self.step, **last_metrics})
            if cfg.ckpt_dir and self.step % cfg.ckpt_every == 0:
                ckpt_lib.save(cfg.ckpt_dir, self.step,
                              {"params": self.params, "opt": self.opt_state},
                              keep=cfg.keep)
        if cfg.ckpt_dir:
            ckpt_lib.save(cfg.ckpt_dir, self.step,
                          {"params": self.params, "opt": self.opt_state},
                          keep=cfg.keep)
        return last_metrics
