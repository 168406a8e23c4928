"""Plain PyTorch reference of one training job of the float FENIX-CNN or
FENIX-RNN (paper §6): the forward pass, the class-weighted NLL, the
gradients by autograd, and AdamW with global-norm clipping, linear
warm-up and a cosine decay, step by step in float32.

It imports nothing of the program.  The model is restated from its
widths: bucket ids (``model_ref.bucketize``), the two embedding tables,
then for the CNN each 'same' conv1d as im2col and one matmul with its
bias and relu, the mean over the window, the FC layers with relu and the
head; for the RNN ``h = tanh(x_t wx + h wh + b)`` over the window and the
head.  The loss is the mean over the batch of each row's weight times
its negative log-likelihood.  The optimizer's rules, each as the mix
states its settings:

* step t counts from 1; the learning rate is ``lr * min(t / warmup, 1)
  * (1 + cos(pi * clip((t - warmup) / (steps - warmup), 0, 1))) / 2``
  (``schedule`` "cosine"; "constant" drops the cosine factor);
* the gradients are scaled by ``min(grad_clip / max(|g|, 1e-9), 1)``,
  ``|g|`` the global norm over every leaf;
* ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, the update
  ``m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)``, plus
  ``weight_decay * p`` on leaves of two or more dimensions, times the
  learning rate, taken from the leaf;
* a step whose loss is not finite changes nothing.

Matmuls run in full float32: TF32 is switched off while a job runs.
``fault`` plants one of the faults the comparison must refuse, in the
reference put in the program's place (``portbench/control.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model_ref import _log2_table, bucketize

F32 = torch.float32
FAULTS = ("half_batch", "index_shift", "no_weight_decay", "skip_update")


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """TF32 off for matmuls and convolutions, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def logits(cfg: Dict, p: Dict[str, torch.Tensor], payload: torch.Tensor,
           log2) -> torch.Tensor:
    """payload [B, T, 2] int32 -> float32 logits [B, classes]."""
    ids = bucketize(cfg, payload, log2)
    x = torch.cat([p["embed_len/table"][ids[..., 0]],
                   p["embed_ipd/table"][ids[..., 1]]], dim=-1)
    if cfg["kind"] == "rnn":
        h = x.new_zeros((x.shape[0], cfg["rnn_units"]))
        for t in range(x.shape[1]):
            h = torch.tanh(x[:, t] @ p["cell/wx"] + h @ p["cell/wh"]
                           + p["cell/b"])
        return h @ p["head/w"] + p["head/b"]
    for i in range(len(cfg["conv_filters"])):
        w = p[f"conv{i}/w"]
        kk, cin, cout = w.shape
        b, n = x.shape[:2]
        pad = kk // 2
        xp = F.pad(x, (0, 0, pad, kk - 1 - pad))
        cols = torch.stack([xp[:, j:j + n] for j in range(kk)], dim=2)
        x = torch.relu(cols.reshape(b * n, kk * cin)
                       @ w.reshape(kk * cin, cout)
                       + p[f"conv{i}/b"]).reshape(b, n, cout)
    x = x.mean(dim=1)
    for i in range(len(cfg["fc_dims"])):
        x = torch.relu(x @ p[f"fc{i}/w"] + p[f"fc{i}/b"])
    return x @ p["head/w"] + p["head/b"]


def weighted_nll(z: torch.Tensor, label: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(z, dim=-1)
    nll = -logp.gather(1, label[:, None])[:, 0]
    return (nll * weight).mean()


def lr_at(mix: Dict, t: int) -> float:
    warm = max(int(mix["warmup_steps"]), 1)
    total = int(mix["job_steps"])
    lr = float(mix["lr"]) * min(t / warm, 1.0)
    if mix["schedule"] == "constant":
        return lr
    prog = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * prog))


def run_job(cfg: Dict, mix: Dict, data: Dict[str, np.ndarray],
            init: Dict[str, torch.Tensor], indices: List[np.ndarray], dev,
            keep: int, fault: Optional[str] = None) -> Dict:
    """One job from ``init`` over the steps' row ``indices`` into
    ``data`` (``payload`` [N, T, 2] int32, ``label`` [N], ``weight``
    [N]).  Returns on the CPU: each step's loss, the clipped gradient of
    step 1 (``grad1``), the leaves after step ``keep`` (``params_k``),
    and the leaves and moments after the last step (``final``)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    dev = torch.device(dev)
    b1, b2, eps = float(mix["b1"]), float(mix["b2"]), float(mix["eps"])
    wd = 0.0 if fault == "no_weight_decay" else float(mix["weight_decay"])
    clip_to = float(mix["grad_clip"])
    d = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in data.items()}
    p = {k: v.detach().to(dev, F32).clone() for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    log2 = _log2_table(dev)
    out = {"losses": []}

    def cpu(tree):
        return {k: x.detach().cpu().clone() for k, x in tree.items()}

    with full_float32():
        for t, idx in enumerate(indices, start=1):
            idx = torch.from_numpy(np.array(idx, np.int64)).to(dev)
            if fault == "index_shift":
                idx[0] = (idx[0] + 1) % d["label"].shape[0]
            if fault == "half_batch":
                idx = idx[:(len(idx) + 1) // 2]
            leaves = {k: x.detach().requires_grad_() for k, x in p.items()}
            loss = weighted_nll(logits(cfg, leaves, d["payload"][idx], log2),
                                d["label"][idx].long(), d["weight"][idx])
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            loss = loss.detach()
            out["losses"].append(float(loss))
            g = {k: torch.zeros_like(p[k]) if x is None else x
                 for k, x in zip(leaves, grads)}
            with torch.no_grad():
                norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
                scale = torch.clamp_max(
                    clip_to / torch.clamp_min(norm, 1e-9), 1.0)
                g = {k: x * scale for k, x in g.items()}
                if t == 1:
                    out["grad1"] = cpu(g)
                live = bool(torch.isfinite(loss)) and not (
                    fault == "skip_update" and t == 2)
                if live:
                    lr = lr_at(mix, t)
                    for k in p:
                        m[k] = b1 * m[k] + (1 - b1) * g[k]
                        v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
                        upd = (m[k] / (1 - b1 ** t)) / (
                            torch.sqrt(v2[k] / (1 - b2 ** t)) + eps)
                        if wd > 0 and p[k].ndim >= 2:
                            upd = upd + wd * p[k]
                        p[k] = p[k] - lr * upd
            if t == keep:
                out["params_k"] = cpu(p)
    out["final"] = {"params": cpu(p), "m": cpu(m), "v": cpu(v2)}
    return out
