"""npz checkpointing with atomic rename, keep-k and async writes.

Port of ``repro/train/checkpoint.py``, in the reference's layout, so
each side reads the other's checkpoints: ``step_XXXXXXXX/`` holds
``state.npz`` (the state tree flattened with ``␟``-joined keys),
``meta.json`` and the ``COMPLETE`` sentinel.  A step is visible only
once its directory is renamed into place, so a writer that dies never
corrupts the latest checkpoint; ``restore_latest`` picks the newest
complete step.

Tensors are written as numpy arrays (read back from their device), and
:func:`restore` returns numpy arrays: the trainer copies them into its
own buffers, ``serving.load_quantized`` hands them to
``qparams_from_numpy``.  numpy has no bfloat16: a bfloat16 tensor is
written as its two bytes a value (dtype ``V2``), the bytes the
reference's ``np.asarray`` of a JAX bfloat16 array writes, and read back
as a bfloat16 tensor (the reference's own ``restore`` refuses those
arrays: ``jnp.asarray`` of ``V2``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "␟"
_SENTINEL = "COMPLETE"
_BF16_BYTES = np.dtype("V2")     # a bfloat16 array's bytes in the file


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(_SEP)
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return tree


def to_numpy(tree: Any) -> Any:
    """A nested dict of tensors, arrays and numbers -> the same tree of
    numpy arrays (tensors copied back from their device: a step may
    write its buffers while the copy is being saved)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BYTES)
        return t.numpy()
    return np.asarray(tree)


def _from_file(a: np.ndarray) -> Any:
    """An array as read from ``state.npz``; bfloat16 bytes as a tensor."""
    if a.dtype == _BF16_BYTES:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return a


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         keep: int = 3, meta: Optional[Dict] = None) -> str:
    """Write {params, opt, ...}; atomic via tmp dir + rename."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(to_numpy(state))
    np.savez(os.path.join(tmp, "state.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
    with open(os.path.join(tmp, _SENTINEL), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in sorted(os.listdir(ckpt_dir)):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, _SENTINEL)):
            out.append(int(d.split("_")[1]))
    return out


def restore(ckpt_dir: str, step: int) -> Tuple[Dict[str, Any], Dict]:
    """(the state tree as numpy arrays, bfloat16 ones as tensors, meta) of
    one step."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "state.npz")) as data:
        flat = {k: _from_file(data[k]) for k in data.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return _unflatten(flat), meta


def restore_latest(ckpt_dir: str) -> Optional[Tuple[Dict, Dict]]:
    steps = list_steps(ckpt_dir)
    if not steps:
        return None
    return restore(ckpt_dir, steps[-1])


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Dict[str, Any],
             meta: Optional[Dict] = None) -> None:
        self.wait()
        # read back now, so training can write its buffers at once
        host_state = to_numpy(state)
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_state),
            kwargs={"keep": self.keep, "meta": meta}, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
