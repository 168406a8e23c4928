"""Switch-resident lightweight decision tree (§4.1).

"For flows without a classification, a lightweight decision tree
implemented on the switch ASIC provides packet-level preliminary
inference."

Port of ``repro/core/data_engine/decision_tree.py``.  ``TreeParams`` and
``fit_tree`` are the port's own copy of the numpy CART fit (so both
packages fit the same tree from the same data); ``tree_arrays`` puts a
fitted tree — the port's or the reference's, any object with numpy
``feature``/``threshold``/``leaf_class`` — on a device, and ``predict``
walks it with branchless integer compares: node = 2*node + 1 +
(feature >= threshold).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

I32 = torch.int32


@dataclasses.dataclass
class TreeParams:
    feature: np.ndarray    # [n_nodes] int32 feature index (internal nodes)
    threshold: np.ndarray  # [n_nodes] int32
    leaf_class: np.ndarray  # [n_leaves] int32

    @property
    def depth(self) -> int:
        return int(np.log2(len(self.leaf_class)))


def fit_tree(x: np.ndarray, y: np.ndarray, depth: int = 4,
             num_classes: int = 2, rng: Optional[np.random.Generator] = None
             ) -> TreeParams:
    """Greedy CART (gini) with integer thresholds on a complete tree."""
    n_nodes = (1 << depth) - 1
    feature = np.zeros(n_nodes, np.int32)
    threshold = np.zeros(n_nodes, np.int32)
    leaf_class = np.zeros(1 << depth, np.int32)
    idx_sets = {0: np.arange(len(y))}
    for node in range(n_nodes):
        idx = idx_sets.get(node, np.array([], np.int64))
        best = (np.inf, 0, 0)
        if len(idx) > 1:
            for f in range(x.shape[1]):
                vals = np.unique(x[idx, f])
                if len(vals) < 2:
                    continue
                cand = np.percentile(vals, [20, 35, 50, 65, 80]
                                     ).astype(np.int64)
                for th in np.unique(cand):
                    right = x[idx, f] >= th
                    g = 0.0
                    for side in (right, ~right):
                        ys = y[idx[side]]
                        if len(ys) == 0:
                            continue
                        ps = np.bincount(ys, minlength=num_classes) / len(ys)
                        g += (1 - np.sum(ps ** 2)) * len(ys)
                    if g < best[0]:
                        best = (g, f, int(th))
        feature[node], threshold[node] = best[1], best[2]
        if len(idx):
            right = x[idx, best[1]] >= best[2]
            idx_sets[2 * node + 1] = idx[~right]
            idx_sets[2 * node + 2] = idx[right]
    first_leaf = n_nodes
    for leaf in range(1 << depth):
        idx = idx_sets.get(first_leaf + leaf, np.array([], np.int64))
        if len(idx):
            leaf_class[leaf] = np.argmax(np.bincount(y[idx],
                                                     minlength=num_classes))
    return TreeParams(feature, threshold, leaf_class)


def tree_arrays(tree, device=None) -> Dict[str, torch.Tensor]:
    """A fitted tree's arrays as int32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(getattr(tree, k)),
                               dtype=I32).to(device)
            for k in ("feature", "threshold", "leaf_class")}


def predict(arrs: Dict[str, torch.Tensor], feats: torch.Tensor,
            depth: int) -> torch.Tensor:
    """feats [..., n_feat] int32 -> class [...] int32.  Branchless walk:
    every lane gathers its node's feature and threshold each level."""
    node = torch.zeros(feats.shape[:-1], dtype=torch.int64,
                       device=feats.device)
    for _ in range(depth):
        f = arrs["feature"][node]
        th = arrs["threshold"][node]
        x = torch.take_along_dim(feats, f.long()[..., None], dim=-1)[..., 0]
        node = 2 * node + 1 + (x >= th).long()
    leaf = node - len(arrs["feature"])
    return arrs["leaf_class"][leaf]
