"""NetBeacon [USENIX Sec'23] baseline: multi-phase tree models in the
switch.

Port of ``repro/baselines/netbeacon.py``.  Per §7.1(f): each phase is a
Random Forest (3 trees, depth 7) evaluated at a packet-count checkpoint
with flow-level register features; predictions update only at phase
boundaries (the paper's noted limitation for fine-grained per-packet
tasks).

The forests fit in numpy from one ``default_rng(seed)`` (phases outer,
trees inner: the reference's bootstrap draws) and predict on the device.
The reference votes row by row (``np.bincount(...).argmax()``); here the
vote is one device op, a one-hot sum over the trees and ``argmax``,
which returns the first maximum: on a tie, the lowest class, as
``bincount`` gives.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.baselines.common import flow_feature_matrix
from repro_torch.core.data_engine.decision_tree import (fit_tree, predict,
                                                        tree_arrays)
from repro_torch.data.synthetic_traffic import Flow

_DEPTH = 7
_N_TREES = 3
_PHASES = (3, 7, 15)


def forest_vote(votes: torch.Tensor, num_classes: int) -> torch.Tensor:
    """votes [trees, N] int -> the majority class [N] int32; a tie goes to
    the lowest class."""
    classes = torch.arange(num_classes, device=votes.device)
    counts = (votes[..., None] == classes).sum(0)      # [N, classes]
    return torch.argmax(counts, dim=-1).to(torch.int32)


class NetBeaconModel:
    """Fits on the host; predicts on ``device`` (``cuda`` unless the
    caller names another)."""

    def __init__(self, num_classes: int, seed: int = 0,
                 device: DeviceLike = None):
        self.num_classes = num_classes
        self.seed = seed
        self.device = resolve_device(device)
        self.phase_forests: List[List[Dict[str, torch.Tensor]]] = []

    def fit(self, flows: List[Flow]) -> None:
        rng = np.random.default_rng(self.seed)
        self.phase_forests = []
        for p in _PHASES:
            x, y, _ = flow_feature_matrix(flows, positions=(p,))
            x = x.astype(np.int64)
            forest = []
            for _ in range(_N_TREES):
                idx = rng.integers(0, len(y), len(y))   # bootstrap
                tree = fit_tree(x[idx], y[idx], depth=_DEPTH,
                                num_classes=self.num_classes)
                forest.append(tree_arrays(tree, self.device))
            self.phase_forests.append(forest)

    def _forest_predict(self, forest, x: np.ndarray) -> np.ndarray:
        xt = torch.as_tensor(x.astype(np.int32)).to(self.device)
        votes = torch.stack([predict(t, xt, _DEPTH) for t in forest])
        return forest_vote(votes, self.num_classes).cpu().numpy()

    def predict_packets(self, flows: List[Flow]) -> Dict[str, np.ndarray]:
        """Per-checkpoint predictions (phase verdict holds until the next)."""
        preds, labels, fids = [], [], []
        for pi, p in enumerate(_PHASES):
            x, y, f = flow_feature_matrix(flows, positions=(p,))
            pr = self._forest_predict(self.phase_forests[pi], x)
            preds.append(pr)
            labels.append(y)
            fids.append(f)
        return {"pred": np.concatenate(preds),
                "label": np.concatenate(labels),
                "flow": np.concatenate(fids)}
