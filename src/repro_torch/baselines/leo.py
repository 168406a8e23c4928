"""Leo [NSDI'24] baseline: online decision tree at line rate.

Port of ``repro/baselines/leo.py``.  Per the paper's §7.1(g): a decision
tree (deep, up to 1024 leaf nodes) on packet-length extremes and
cumulative flow length, evaluated per packet from switch register
state.  A complete-tree CART of depth 10 (= 1024 leaves) on the same
prefix features Leo uses, fit in numpy (``decision_tree.fit_tree``, the
reference's fit) and walked on the device with int32 features, as the
reference passes them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.baselines.common import flow_feature_matrix
from repro_torch.core.data_engine.decision_tree import (TreeParams, fit_tree,
                                                        predict, tree_arrays)
from repro_torch.data.synthetic_traffic import Flow

# feature indices used by Leo: min_len, max_len, cum_len, pkt_cnt
_LEO_FEATS = (0, 1, 3, 4)
_DEPTH = 10


class LeoModel:
    """Fits on the host; predicts on ``device`` (``cuda`` unless the
    caller names another)."""

    def __init__(self, num_classes: int, device: DeviceLike = None):
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self.tree: TreeParams = None
        self.arrs: Dict[str, torch.Tensor] = None

    def fit(self, flows: List[Flow], positions=(1, 3, 7, 15, 31)) -> None:
        x, y, _ = flow_feature_matrix(flows, positions)
        x = x[:, _LEO_FEATS].astype(np.int64)
        self.tree = fit_tree(x, y, depth=_DEPTH,
                             num_classes=self.num_classes)
        self.arrs = tree_arrays(self.tree, self.device)

    def predict_packets(self, flows: List[Flow], positions=(1, 3, 7, 15, 31)
                        ) -> Dict[str, np.ndarray]:
        xs, ys, fs = flow_feature_matrix(flows, positions)
        x = torch.as_tensor(xs[:, _LEO_FEATS].astype(np.int32)).to(
            self.device)
        pred = predict(self.arrs, x, _DEPTH).cpu().numpy()
        return {"pred": pred, "label": ys, "flow": fs}
