"""Elastic scaling on one card: the port's counterpart of
``repro/distributed/elastic.py``.

The reference remeshes a checkpoint onto another device count: its
checkpoints are mesh-agnostic full arrays, so scaling up or down is load
-> new mesh + rules -> new pspecs -> ``device_put``.  The port runs on one
card, the only target it has: ``plan_remesh`` plans for it (one device,
every parameter replicated, no fallbacks) and ``reshard_state`` places a
host checkpoint (numpy arrays, the layout ``train/checkpoint.py`` and the
reference write) on it.  A target of more than one device raises, as the
mesh builders of ``launch/mesh.py`` do.  ``scale_step_capacity``, the
fleet-size arithmetic, is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import NO_MESH
from repro_torch.models import api
from repro_torch.models.param import params_from_numpy


@dataclasses.dataclass
class RemeshPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    pspecs: Dict[str, Tuple]       # () for every parameter: replicated
    fallbacks: list

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh_shape))


def plan_remesh(cfg: ModelConfig,
                mesh_shape: Optional[Tuple[int, ...]] = None) -> RemeshPlan:
    """Dry plan for the card: a mesh of ``(1,)``, every parameter of
    ``cfg`` replicated (spec ``()``), no fallbacks.  ``mesh_shape`` of
    more than one device raises."""
    if mesh_shape is not None and int(np.prod(mesh_shape)) != 1:
        raise ValueError(f"plan_remesh onto {tuple(mesh_shape)}: {NO_MESH}")
    params, _ = api.init_params(cfg, abstract=True)
    return RemeshPlan((1,), ("card",), {k: () for k in params}, [])


def reshard_state(state: Dict[str, Any], plan: RemeshPlan,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Place a host checkpoint state (the reference's flat dict of numpy
    arrays) on the card (``device``, ``cuda`` by default) through
    ``param.params_from_numpy``: bit for bit, bfloat16 included."""
    if plan.n_devices != 1:
        raise ValueError(f"reshard_state onto {plan.mesh_shape}: {NO_MESH}")
    return params_from_numpy(state, device)


def scale_step_capacity(old_devices: int, new_devices: int,
                        global_batch: int) -> Tuple[int, int]:
    """Keep global batch fixed; recompute per-device batch + grad-accum.

    Returns (per_device_batch, accum_steps): if the new fleet cannot divide
    the global batch evenly, gradient accumulation keeps semantics stable
    (the 1000-node elastic policy: same tokens/step across scale events).
    """
    per = max(1, global_batch // new_devices)
    accum = max(1, int(np.ceil(global_batch / (per * new_devices))))
    return per, accum
