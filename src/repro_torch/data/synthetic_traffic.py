"""Class-conditioned synthetic network traffic (ISCXVPN2016 / USTC-TFC
analogues), numpy only.

The port's own copy of ``repro/data/synthetic_traffic.py``, so a trace,
its oracle payloads and its training windows can be made on a machine
without the reference's dependencies.  Given the same arguments both
produce the same arrays.  Each class is a parametric flow generator
over packet lengths and inter-packet delays; class imbalance follows the
paper's Table 1 (``class_weights`` gives the §6 over/under-sampling
weights).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

ISCX_CLASSES = ("chat", "email", "file", "p2p", "stream", "voip", "web")
ISCX_RATIO = (11, 4, 13, 10, 18, 128, 1)

USTC_CLASSES = ("cridex", "ftp", "geodo", "htbot", "neris", "nsis-ay",
                "warcraft", "zeus", "virut", "weibo", "shifu", "smb")
USTC_RATIO = (92, 10, 4, 14, 17, 23, 105, 1, 16, 132, 27, 1)


@dataclasses.dataclass
class ClassProfile:
    len_mean: float
    len_std: float
    len_bimodal: float      # probability of an MTU-sized packet
    ipd_log_mu: float       # log10 microseconds
    ipd_log_sigma: float
    burstiness: float       # prob of continuing a burst (tiny IPD)
    flow_len_mean: int


def _profiles(task: str) -> List[ClassProfile]:
    if task == "iscx":
        return [
            ClassProfile(120, 60, 0.02, 5.2, 0.7, 0.10, 60),    # chat
            ClassProfile(420, 180, 0.10, 4.6, 0.8, 0.25, 40),   # email
            ClassProfile(1250, 220, 0.55, 3.2, 0.6, 0.70, 220),  # file
            ClassProfile(1050, 320, 0.45, 3.5, 0.9, 0.55, 180),  # p2p
            ClassProfile(1330, 120, 0.70, 3.9, 0.4, 0.60, 300),  # stream
            ClassProfile(172, 24, 0.00, 4.3, 0.15, 0.05, 400),  # voip
            ClassProfile(640, 420, 0.25, 4.0, 1.1, 0.40, 50),   # web
        ]
    # ustc malware/benign mix: each family gets a distinct temporal
    # signature (beacon cadence, transfer bursts, chatty C2, bulk SMB...)
    base = [
        ClassProfile(140, 30, 0.02, 5.6, 0.25, 0.05, 80),   # cridex: slow beacon
        ClassProfile(1350, 150, 0.65, 3.0, 0.5, 0.75, 150),  # ftp: bulk
        ClassProfile(420, 60, 0.05, 4.9, 0.35, 0.12, 60),   # geodo: med beacon
        ClassProfile(250, 180, 0.20, 3.6, 1.3, 0.45, 100),  # htbot: erratic
        ClassProfile(90, 25, 0.01, 4.1, 0.9, 0.30, 90),     # neris: tiny spam
        ClassProfile(700, 120, 0.30, 4.4, 0.5, 0.25, 110),  # nsis-ay
        ClassProfile(190, 40, 0.00, 4.35, 0.12, 0.05, 300),  # warcraft: game tick
        ClassProfile(520, 90, 0.08, 5.1, 0.4, 0.10, 85),    # zeus: fat beacon
        ClassProfile(330, 250, 0.35, 3.3, 1.1, 0.60, 95),   # virut: bursty mix
        ClassProfile(980, 280, 0.45, 3.8, 0.8, 0.50, 70),   # weibo: media
        ClassProfile(620, 70, 0.12, 4.65, 0.2, 0.08, 75),   # shifu: regular mid
        ClassProfile(1180, 220, 0.55, 3.45, 0.4, 0.65, 130),  # smb: bulk lan
    ]
    return base


def task_meta(task: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    if task == "iscx":
        return ISCX_CLASSES, ISCX_RATIO
    if task == "ustc":
        return USTC_CLASSES, USTC_RATIO
    raise ValueError(task)


@dataclasses.dataclass
class Flow:
    label: int
    five_tuple: Tuple[int, int, int, int, int]
    start_us: int
    pkt_len: np.ndarray       # [n] int32
    ipd_us: np.ndarray        # [n] int32 (ipd[0] = 0)

    @property
    def ts_us(self) -> np.ndarray:
        return (self.start_us + np.cumsum(self.ipd_us)).astype(np.int64)


def make_flows(task: str, n_flows: int, seed: int = 0,
               duration_s: float = 60.0,
               min_per_class: int = 0) -> List[Flow]:
    """min_per_class stratifies rare classes (the paper's 100k-flow corpora
    have >=200 flows even for ratio-1 classes; small synthetic runs need the
    floor to make macro-F1 measurable)."""
    rng = np.random.default_rng(seed)
    classes, ratio = task_meta(task)
    profs = _profiles(task)
    probs = np.asarray(ratio, np.float64) / sum(ratio)
    labels = rng.choice(len(classes), size=n_flows, p=probs)
    if min_per_class:
        counts = np.bincount(labels, minlength=len(classes))
        fix = []
        for c in range(len(classes)):
            fix += [c] * max(min_per_class - counts[c], 0)
        if fix:
            idx = rng.choice(n_flows, len(fix), replace=False)
            labels[idx] = np.asarray(fix)
    flows: List[Flow] = []
    for i, lab in enumerate(labels):
        p = profs[lab]
        n = max(10, int(rng.gamma(3.0, p.flow_len_mean / 3.0)))
        n = min(n, 2000)
        # per-flow jitter: shift the whole flow's signature
        lm = p.len_mean * rng.uniform(0.8, 1.25)
        im = p.ipd_log_mu + rng.normal(0, 0.25)
        mtu = rng.random(n) < p.len_bimodal
        lens = np.where(
            mtu, 1500 - rng.integers(0, 60, n),
            np.clip(rng.normal(lm, p.len_std, n), 40, 1500))
        in_burst = rng.random(n) < p.burstiness
        ipd = np.where(
            in_burst,
            rng.integers(20, 400, n),
            (10.0 ** rng.normal(im, p.ipd_log_sigma, n))).astype(np.int64)
        ipd = np.clip(ipd, 10, 5_000_000)
        ipd[0] = 0
        start = int(rng.uniform(0, duration_s * 1e6 * 0.5))
        ft = (int(rng.integers(1, 2**31)), int(rng.integers(1, 2**31)),
              int(rng.integers(1024, 65535)), int(rng.integers(1, 1024)),
              6 if rng.random() < 0.8 else 17)
        flows.append(Flow(int(lab), ft, start,
                          lens.astype(np.int32), ipd.astype(np.int32)))
    return flows


def uniform_flow_stream(n_pkts: int, n_flows: int, seed: int = 0,
                        gap_us: int = 10) -> Dict[str, np.ndarray]:
    """Interleaved multi-packet flows at a fixed aggregate rate.

    A structureless load generator (vs the class-conditioned ``make_flows``
    path): ``n_flows`` random persistent 5-tuples with per-flow-constant
    packet lengths, arrivals uniform at ``1e6 / gap_us`` offered pps.
    Flows persist, so the flow table, backlog counters, and probability
    gate see realistic per-flow state.  Used by the engine-farm benchmarks
    and CI smokes; includes ``flow_idx`` for per-flow assertions.
    """
    rng = np.random.default_rng(seed)
    five = {k: rng.integers(1, 2**31, n_flows).astype(np.uint32)
            for k in ("src_ip", "dst_ip")}
    five["src_port"] = rng.integers(1, 65536, n_flows).astype(np.uint32)
    five["dst_port"] = rng.integers(1, 65536, n_flows).astype(np.uint32)
    five["proto"] = rng.integers(6, 18, n_flows).astype(np.uint32)
    lens = (40 + rng.integers(0, 1400, n_flows)).astype(np.int32)
    fidx = rng.integers(0, n_flows, n_pkts).astype(np.int32)
    stream = {k: v[fidx] for k, v in five.items()}
    stream["pkt_len"] = lens[fidx]
    stream["ts_us"] = np.sort(
        rng.integers(0, n_pkts * gap_us, n_pkts)).astype(np.int32)
    stream["flow_idx"] = fidx
    return stream


def ring_window(feats: np.ndarray, end: int, win: int) -> np.ndarray:
    """Window ENDING at packet `end` inclusive, front-padded with zeros —
    exactly what the switch ring buffer holds when packet `end` arrives."""
    lo = max(0, end + 1 - win)
    w = feats[lo:end + 1]
    if len(w) < win:
        w = np.concatenate([np.zeros((win - len(w), feats.shape[1]),
                                     feats.dtype), w])
    return w


def oracle_payloads(oracle: List[np.ndarray], flow_idx: np.ndarray,
                    flow_pos: np.ndarray, win: int) -> np.ndarray:
    """Ground-truth ring window for EVERY packet of a stream, vectorized.

    ``oracle[f]`` is flow f's [n_f, feat_dim] feature sequence; packet i of
    the stream gets ``ring_window(oracle[flow_idx[i]], flow_pos[i], win)``.
    Returns [n, win, feat_dim] int32 — the device trace driver gathers
    granted packets' windows from this array instead of re-deriving them
    per batch on the host.  The packets are grouped by flow with one
    stable sort, so the work is linear in the stream (the reference
    masks the whole stream once per flow); the result is the same.
    """
    from numpy.lib.stride_tricks import sliding_window_view

    flow_idx = np.asarray(flow_idx)
    flow_pos = np.asarray(flow_pos)
    feat_dim = oracle[0].shape[1] if len(oracle) else 2
    out = np.zeros((len(flow_idx), win, feat_dim), np.int32)
    order = np.argsort(flow_idx, kind="stable")
    flows, starts = np.unique(flow_idx[order], return_index=True)
    for fi, lo, hi in zip(flows, starts, np.append(starts[1:], len(order))):
        rows = order[lo:hi]
        feats = np.asarray(oracle[int(fi)], np.int32)
        padded = np.concatenate(
            [np.zeros((win - 1, feats.shape[1]), np.int32), feats])
        sw = sliding_window_view(padded, win, axis=0)   # [n_f, feat, win]
        out[rows] = np.transpose(sw[flow_pos[rows]], (0, 2, 1))
    return out


def windows_from_flows(flows: List[Flow], win: int = 9,
                       stride: int = 4, max_windows_per_flow: int = 16,
                       seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ring-aligned sliding windows (paper §6): payload [N, win, 2].

    Windows end at sampled packet positions and are front-padded, matching
    the deployed Buffer-Manager semantics (F1..F8 history + F9 current).
    """
    rng = np.random.default_rng(seed)
    ps, ls, fs = [], [], []
    for fi, f in enumerate(flows):
        feats = np.stack([f.pkt_len, f.ipd_us], axis=-1)   # [n,2]
        n = len(f.pkt_len)
        ends = list(range(1, n, stride))
        if len(ends) > max_windows_per_flow:
            ends = list(rng.choice(ends, max_windows_per_flow,
                                   replace=False))
        for e in ends:
            ps.append(ring_window(feats, e, win))
            ls.append(f.label)
            fs.append(fi)
    return (np.stack(ps).astype(np.int32), np.asarray(ls, np.int32),
            np.asarray(fs, np.int32))


def class_weights(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Inverse-frequency weights (the paper's over/under-sampling, §6)."""
    cnt = np.bincount(labels, minlength=n_classes).astype(np.float64)
    w = np.where(cnt > 0, len(labels) / (n_classes * np.maximum(cnt, 1)), 0.0)
    return w[labels]


def packet_stream(flows: List[Flow], limit: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
    """Interleave flows into one time-ordered packet stream (Data Engine)."""
    recs = []
    for fi, f in enumerate(flows):
        ts = f.ts_us
        for j in range(len(f.pkt_len)):
            recs.append((ts[j], fi, f.pkt_len[j]))
    recs.sort()
    if limit:
        recs = recs[:limit]
    n = len(recs)
    out = {
        "ts_us": np.empty(n, np.int32), "pkt_len": np.empty(n, np.int32),
        "src_ip": np.empty(n, np.uint32), "dst_ip": np.empty(n, np.uint32),
        "src_port": np.empty(n, np.uint32),
        "dst_port": np.empty(n, np.uint32),
        "proto": np.empty(n, np.uint32),
        "flow_idx": np.empty(n, np.int32),
        "flow_pos": np.empty(n, np.int32),
        "label": np.empty(n, np.int32),
    }
    pos_ctr: Dict[int, int] = {}
    for i, (ts, fi, ln) in enumerate(recs):
        f = flows[fi]
        out["ts_us"][i] = ts % (2**31 - 1)
        out["pkt_len"][i] = ln
        out["src_ip"][i], out["dst_ip"][i] = f.five_tuple[0], f.five_tuple[1]
        out["src_port"][i], out["dst_port"][i] = (f.five_tuple[2],
                                                  f.five_tuple[3])
        out["proto"][i] = f.five_tuple[4]
        out["flow_idx"][i] = fi
        out["flow_pos"][i] = pos_ctr.get(fi, 0)
        pos_ctr[fi] = out["flow_pos"][i] + 1
        out["label"][i] = f.label
    return out


def train_test_split(x, y, f, test_frac: float = 0.2, seed: int = 0):
    """Split BY FLOW (no window leakage between train and test)."""
    rng = np.random.default_rng(seed)
    flow_ids = np.unique(f)
    rng.shuffle(flow_ids)
    n_test = max(1, int(len(flow_ids) * test_frac))
    test_flows = set(flow_ids[:n_test].tolist())
    mask = np.asarray([fi in test_flows for fi in f])
    return (x[~mask], y[~mask], f[~mask]), (x[mask], y[mask], f[mask])
