"""FlowLens [NDSS'21] baseline: flow markers on the switch + control-plane
gradient-boosted trees.

Port of ``repro/baselines/flowlens.py``: the port's own numpy copy.  Per
§7.1(c): the switch accumulates per-flow "flow marker" histograms
(packet-size and inter-packet-delay bin counts); the control plane runs
an XGBoost-style classifier on the collected markers.  Flow-level only,
with millisecond collection+inference latency (the Figure 11
comparison).  The booster is the paper's control-plane CPU classifier,
so it stays on the host, as in the reference: a compact multiclass GBDT
(softmax objective, depth-3 regression trees, shrinkage 0.3) whose
predictions equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.data.synthetic_traffic import Flow

_LEN_BINS = np.array([64, 128, 256, 512, 768, 1024, 1280, 1500])
_IPD_BINS = np.array([100, 1000, 10_000, 100_000, 1_000_000])


def flow_marker(flow: Flow, max_pkts: int = 64) -> np.ndarray:
    """FlowLens FMA: truncated histograms of sizes and IPDs."""
    ln = flow.pkt_len[:max_pkts]
    ipd = flow.ipd_us[1:max_pkts]
    h1 = np.histogram(ln, bins=np.concatenate([[0], _LEN_BINS]))[0]
    h2 = np.histogram(ipd, bins=np.concatenate([[0], _IPD_BINS]))[0]
    return np.concatenate([h1, h2, [len(ln)]]).astype(np.float64)


def markers(flows: List[Flow]) -> Tuple[np.ndarray, np.ndarray]:
    x = np.stack([flow_marker(f) for f in flows])
    y = np.asarray([f.label for f in flows], np.int32)
    return x, y


# ---------------------------------------------------------------------------
# Tiny multiclass GBDT
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _RegTree:
    feature: np.ndarray
    threshold: np.ndarray
    value: np.ndarray      # leaf values

    def predict(self, x: np.ndarray) -> np.ndarray:
        node = np.zeros(len(x), np.int64)
        n_internal = len(self.feature)
        depth = int(np.log2(n_internal + 1))
        for _ in range(depth):
            f = self.feature[node]
            t = self.threshold[node]
            node = 2 * node + 1 + (x[np.arange(len(x)), f] >= t)
        return self.value[node - n_internal]


def _fit_reg_tree(x: np.ndarray, g: np.ndarray, depth: int = 3) -> _RegTree:
    """Fit residuals g with a complete variance-reduction tree."""
    n_internal = (1 << depth) - 1
    feat = np.zeros(n_internal, np.int64)
    thr = np.zeros(n_internal, np.float64)
    value = np.zeros(1 << depth, np.float64)
    sets = {0: np.arange(len(g))}
    for node in range(n_internal):
        idx = sets.get(node, np.array([], np.int64))
        best = (np.inf, 0, 0.0)
        if len(idx) > 4:
            for f in range(x.shape[1]):
                vals = x[idx, f]
                cand = np.unique(np.percentile(vals, [25, 50, 75]))
                for t in cand:
                    right = vals >= t
                    if right.all() or (~right).all():
                        continue
                    sse = g[idx[right]].var() * right.sum() \
                        + g[idx[~right]].var() * (~right).sum()
                    if sse < best[0]:
                        best = (sse, f, float(t))
        feat[node], thr[node] = best[1], best[2]
        if len(idx):
            right = x[idx, best[1]] >= best[2]
            sets[2 * node + 1] = idx[~right]
            sets[2 * node + 2] = idx[right]
    first = n_internal
    for leaf in range(1 << depth):
        idx = sets.get(first + leaf, np.array([], np.int64))
        value[leaf] = g[idx].mean() if len(idx) else 0.0
    return _RegTree(feat, thr, value)


class FlowLensModel:
    def __init__(self, num_classes: int, rounds: int = 25, lr: float = 0.3,
                 depth: int = 3):
        self.k = num_classes
        self.rounds = rounds
        self.lr = lr
        self.depth = depth
        self.trees: List[List[_RegTree]] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        n = len(y)
        fmat = np.zeros((n, self.k))
        onehot = np.eye(self.k)[y]
        for _ in range(self.rounds):
            p = np.exp(fmat - fmat.max(1, keepdims=True))
            p /= p.sum(1, keepdims=True)
            grads = onehot - p                     # negative gradient
            round_trees = []
            for c in range(self.k):
                t = _fit_reg_tree(x, grads[:, c], depth=self.depth)
                fmat[:, c] += self.lr * t.predict(x)
                round_trees.append(t)
            self.trees.append(round_trees)

    def predict(self, x: np.ndarray) -> np.ndarray:
        fmat = np.zeros((len(x), self.k))
        for round_trees in self.trees:
            for c, t in enumerate(round_trees):
                fmat[:, c] += self.lr * t.predict(x)
        return fmat.argmax(1).astype(np.int32)
