"""N3IC [NSDI'22] baseline: binary MLP on a SmartNIC.

Port of ``repro/baselines/n3ic.py``.  Per §7.1(i): binary-weight MLP
with hidden layers [128, 64, 10] over flow-level + packet-level
features.  (The paper simulates the NIC side in software due to
hardware constraints; ours is the same simulation.)  The NIC bottleneck
FENIX's Fig. 1 highlights is throughput, not accuracy — N3IC's accuracy
lands between the switch-tree methods and FENIX.

``build_features`` is numpy, as the reference's (bit for bit); the
binarization is BoS's straight-through estimator.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.baselines.bos import _binarize_ste
from repro_torch.baselines.common import flow_feature_matrix
from repro_torch.data.synthetic_traffic import Flow
from repro_torch.models.traffic import nll_and_acc
from repro_torch.models.param import Registrar

F32 = torch.float32
_HIDDEN = (128, 64, 10)


def build_features(flows: List[Flow], positions=(3, 7, 15)
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    x, y, f = flow_feature_matrix(flows, positions)
    # log-scale the magnitudes, z-score-free (NIC integer pipeline style)
    x = np.log1p(np.abs(x)).astype(np.float32)
    return x, y, f


def init(n_features: int, num_classes: int, seed: int = 0,
         device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The float32 params on ``device`` (``cuda`` unless the caller names
    another), bit for bit the reference's."""
    reg = Registrar(abstract=False, seed=seed, dtype=F32,
                    device=resolve_device(device))
    prev = n_features
    for i, h in enumerate(_HIDDEN):
        reg.param(f"fc{i}/w", (prev, h), ("embed", "ffn"),
                  scale=prev ** -0.5, dtype=F32)
        reg.param(f"fc{i}/b", (h,), ("ffn",), init="zeros", dtype=F32)
        prev = h
    reg.param("head/w", (prev, num_classes), ("embed", "classes"),
              scale=prev ** -0.5, dtype=F32)
    reg.param("head/b", (num_classes,), ("classes",), init="zeros",
              dtype=F32)
    return reg.params


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, F] float32 features -> logits [B, classes]."""
    for i in range(len(_HIDDEN)):
        w = _binarize_ste(params[f"fc{i}/w"])
        scale = float(1.0 / np.sqrt(w.shape[0]))
        x = torch.relu(x @ w * scale + params[f"fc{i}/b"])
    return x @ params["head/w"] + params["head/b"]


def loss_fn(params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    return nll_and_acc(apply(params, batch["payload"]), batch)
