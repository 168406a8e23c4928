"""Shared feature builders and metrics of the baseline schemes (§7.1).

The port's own numpy copy of ``repro/baselines/common.py``: the
metrics (``macro_f1``, ``per_class_prf``, ``confusion_matrix``,
``flow_vote``) that ``serving.evaluate_quantized`` and the accuracy
protocol read, and the flow-state features that Leo, NetBeacon and N3IC
(``leo.py``, ``netbeacon.py``, ``n3ic.py`` beside this module) build on.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.data.synthetic_traffic import Flow


def flow_prefix_features(flow: Flow, upto: int) -> np.ndarray:
    """Per-packet flow-state features after `upto`+1 packets (switch regs):
    [min_len, max_len, mean_len, cum_len, pkt_cnt, mean_ipd, last_len]."""
    ln = flow.pkt_len[:upto + 1].astype(np.float64)
    ipd = flow.ipd_us[1:upto + 1].astype(np.float64)
    return np.asarray([
        ln.min(), ln.max(), ln.mean(), ln.sum(), len(ln),
        ipd.mean() if len(ipd) else 0.0, ln[-1]], np.float64)


def flow_feature_matrix(flows: List[Flow], positions=(3, 7, 15),
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Features at checkpoint positions: X [N,F], y [N], flow_id [N]."""
    xs, ys, fs = [], [], []
    for fi, f in enumerate(flows):
        for p in positions:
            if p < len(f.pkt_len):
                xs.append(flow_prefix_features(f, p))
                ys.append(f.label)
                fs.append(fi)
    return np.stack(xs), np.asarray(ys, np.int32), np.asarray(fs, np.int32)


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> float:
    f1s = []
    for c in range(n_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-9))
    return float(np.mean(f1s))


def per_class_prf(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int
                  ) -> List[Tuple[float, float]]:
    out = []
    for c in range(n_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        out.append((tp / max(tp + fp, 1), tp / max(tp + fn, 1)))
    return out


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     n_classes: int) -> np.ndarray:
    """[n_classes, n_classes] counts, rows = true class, cols = predicted.

    The per-class companion of :func:`macro_f1`: a high macro-F1 riding
    one majority class shows up here as empty off-diagonal rows.
    """
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (np.asarray(y_true, np.int64),
                   np.asarray(y_pred, np.int64)), 1)
    return cm


def flow_vote(pred: np.ndarray, flow_id: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Majority vote of window/packet predictions per flow."""
    uf = np.unique(flow_id)
    votes = np.empty(len(uf), np.int32)
    for i, f in enumerate(uf):
        p = pred[flow_id == f]
        votes[i] = np.bincount(p).argmax()
    return uf, votes
