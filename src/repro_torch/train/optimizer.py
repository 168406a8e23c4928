"""Hand-rolled AdamW and its learning-rate schedules on flat param dicts.

Port of ``repro/train/optimizer.py``.  The moments are float32 whatever
the param dtype; weight decay skips 1-d params (norms, biases); the
update clips by the global norm of the gradients.  The step counter is a
0-d int32 tensor on the params' device and the learning rate is
computed from it there, so a step reads nothing back to the host (a
captured train step replays with it, as the decode step does with its
position).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # "cosine" | "constant"


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(F32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def init_state(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero moments and a 0-d int32 step counter, on the params' device."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                  for k, v in params.items()},
            "v": {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                  for k, v in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_state(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``init_state``'s shapes and dtypes as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct``s): float32 moments, an int32 step."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    return {"m": {k: meta(v.shape, F32) for k, v in params.items()},
            "v": {k: meta(v.shape, F32) for k, v in params.items()},
            "step": meta((), torch.int32)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(v.to(F32))) for v in tree.values())
    return torch.sqrt(sq)


def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: Dict[str, Any],
                  cfg: OptConfig
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                             Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new_params, new_state, metrics); the
    inputs are not written."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                           1.0) \
        if cfg.grad_clip > 0 else torch.ones((), dtype=F32,
                                             device=gnorm.device)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(F32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(F32))
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(F32) * clip
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        upd = mh / (torch.sqrt(vh) + cfg.eps)
        # decoupled weight decay: skip 1-d params (norms, biases)
        if cfg.weight_decay > 0 and p.ndim >= 2:
            upd = upd + cfg.weight_decay * p.to(F32)
        new_p[k] = (p.to(F32) - lr * upd).to(p.dtype)
        new_m[k] = m
        new_v[k] = v
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                   batch: Dict) -> Tuple[torch.Tensor, Dict, Dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``:
    (loss, aux metrics, grads), each grad a new tensor (zeros for a param
    the loss does not read).  ``params`` are read, not written."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, batch)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(leaves, gs)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics). Returns the step
    ``(params, state, batch) -> (params, state, metrics)``, functional
    as the reference's."""

    def train_step(params, state, batch):
        loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            params, state, opt_metrics = apply_updates(params, grads, state,
                                                       opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, state, metrics

    return train_step
