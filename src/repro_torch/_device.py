"""Device and backend resolution shared by the port's entry points."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]

# kernel backends of the knobs (gate_backend, matmul_backend,
# attn_backend):
#   "cuda"       the hand-written Hopper kernel (default for CUDA tensors)
#   "cuda_prng"  gate only: the admission kernel that draws its own
#                threefry bits on the card (the counterpart of the
#                reference's on-core-PRNG "pallas_tpu")
#   "ref"        the plain PyTorch version (default for CPU tensors; on
#                the card only when asked for by name)
# and how the compiled steps run (step_backend: the replay's chunk step,
# the LM's decode step):
#   "graph"      captured once as a CUDA graph and replayed (the
#                counterpart of the reference's jax.jit; default on CUDA)
#   "eager"      the same step body op by op (default on the CPU; on the
#                card only when asked for by name)
BACKENDS: Dict[str, Tuple[str, ...]] = {
    "gate_backend": ("cuda", "cuda_prng", "ref"),
    "matmul_backend": ("cuda", "ref"),
    "attn_backend": ("cuda", "ref"),
    "step_backend": ("graph", "eager"),
}
_KERNEL_BACKENDS = ("cuda", "cuda_prng")
# the device whose path a ``meta`` tensor takes (``meta_as``): the card's
# unless a trace asks for the CPU's
_META_AS: contextvars.ContextVar[str] = contextvars.ContextVar(
    "meta_as", default="cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA
    is asked for (or implied) and missing — never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


def validate_backend(name: Optional[str], knob: str) -> Optional[str]:
    """Check a backend name of ``knob`` (None keeps the per-device
    default)."""
    if name is not None and name not in BACKENDS[knob]:
        raise ValueError(f"unknown {knob} {name!r}; expected one of "
                         f"{BACKENDS[knob]}")
    return name


@contextlib.contextmanager
def meta_as(device_type: str) -> Iterator[None]:
    """Within the block, ``meta`` tensors take the branches of
    ``device_type`` ("cuda" or "cpu"): the dry run traces the card's path
    on meta tensors (the default) or, to hold a trace against a CPU run,
    the CPU's."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"meta tensors stand for cuda or cpu, not "
                         f"{device_type!r}")
    token = _META_AS.set(device_type)
    try:
        yield
    finally:
        _META_AS.reset(token)


def on_card(tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` takes the card's branches: a CUDA tensor, or a
    ``meta`` one standing for the card (:func:`meta_as`)."""
    return tensor.is_cuda or (tensor.is_meta and _META_AS.get() == "cuda")


def resolve_backend(name: Optional[str], tensor: torch.Tensor,
                    knob: str) -> str:
    """The backend one call runs: ``name``, else ``"cuda"`` for a tensor
    on the card (:func:`on_card`: a ``meta`` tensor traces the card's
    path) and ``"ref"`` for a CPU tensor.  A kernel backend (``"cuda"``,
    ``"cuda_prng"``) with a CPU tensor raises."""
    validate_backend(name, knob)
    if name is None:
        return "cuda" if on_card(tensor) else "ref"
    if name in _KERNEL_BACKENDS and not on_card(tensor):
        raise ValueError(f"{knob}={name!r} runs a Hopper kernel and "
                         f"needs CUDA tensors; got a {tensor.device} "
                         "tensor")
    return name


def resolve_step_backend(name: Optional[str],
                         device: torch.device) -> str:
    """How a compiled step runs on ``device``: ``name``, else ``"graph"``
    on CUDA and ``"eager"`` on the CPU.  ``"graph"`` off CUDA raises."""
    validate_backend(name, "step_backend")
    if name is None:
        return "graph" if device.type == "cuda" else "eager"
    if name == "graph" and device.type != "cuda":
        raise ValueError("step_backend='graph' captures a CUDA graph and "
                         f"needs a CUDA device; got {device}")
    return name


@contextlib.contextmanager
def no_host_sync(device: torch.device) -> Iterator[None]:
    """On CUDA, make any operation that synchronises with the host raise
    (``torch.cuda.set_sync_debug_mode("error")``) for the block."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
