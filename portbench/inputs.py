"""A cell's inputs, made from ``--seed``: the captures its traffic mix
describes and the model's int8 weights, or for a training mix the
labelled windows and the float model's initial weights.

Captures and training sets come from one general flow generator driven
by a mix file's parameters (flows, packets, duration, and per class its
share, packet length and inter-packet delay distributions, burstiness
and flow length), drawn in bulk with numpy.  Weights are random, drawn
on the device in one call a kind from a ``torch.Generator`` seeded with
``--seed``.  For the int8 models each layer's requantization shift and
bias are then picked on a calibration batch of the first capture's
windows, in plain PyTorch, so activations neither vanish nor saturate;
the float models start as the paper's training does (normal weights at
fan-in scale, zero biases).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.model_ref import bucketize, matmul_int8

SEED_MASK = (1 << 63) - 1
_PROFILE = ("ratio", "len_mean", "len_std", "len_bimodal", "ipd_log_mu",
            "ipd_log_sigma", "burstiness", "flow_len_mean")


def _draw_flows(mix: Dict, rng: np.random.Generator) -> Dict:
    """``mix["flows"]`` flows of the mix's classes: each flow's class
    (``label``) and packet count (``n``), and every packet's length and
    delay to its flow's previous packet (0 for a flow's first), flow by
    flow (``f`` the flow of each packet, ``first`` each flow's first
    packet)."""
    cls = mix["classes"]
    prof = {k: np.asarray([c[k] for c in cls], np.float64) for k in _PROFILE}
    n_flows = int(mix["flows"])
    lab = rng.choice(len(cls), size=n_flows, p=prof["ratio"]
                     / prof["ratio"].sum())
    p = {k: v[lab] for k, v in prof.items()}
    n = np.clip(rng.gamma(3.0, p["flow_len_mean"] / 3.0).astype(np.int64),
                10, 2000)
    lm = p["len_mean"] * rng.uniform(0.8, 1.25, n_flows)
    im = p["ipd_log_mu"] + rng.normal(0.0, 0.25, n_flows)
    f = np.repeat(np.arange(n_flows), n)
    total = int(n.sum())
    mtu = rng.random(total) < p["len_bimodal"][f]
    lens = np.where(mtu, 1500 - rng.integers(0, 60, total),
                    np.clip(rng.normal(lm[f], p["len_std"][f]), 40, 1500))
    burst = rng.random(total) < p["burstiness"][f]
    ipd = np.where(burst, rng.integers(20, 400, total),
                   10.0 ** rng.normal(im[f], p["ipd_log_sigma"][f]))
    ipd = np.clip(ipd.astype(np.int64), 10, 5_000_000)
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    ipd[first] = 0
    feats = np.stack([lens.astype(np.int32), ipd.astype(np.int32)], -1)
    return {"label": lab, "n": n, "f": f, "first": first, "lens": lens,
            "ipd": ipd, "feats": feats}


def make_capture(mix: Dict, rng: np.random.Generator
                 ) -> Dict[str, np.ndarray]:
    """One capture: ``mix["flows"]`` flows of the mix's classes, their
    packets interleaved by time, cut to the first ``mix["packets"]``.
    Returns the packet stream (five-tuple uint32, ts_us and pkt_len
    int32) and, under ``"windows"``, the first flows' feature windows
    for calibration."""
    fl = _draw_flows(mix, rng)
    n, f, first, ipd = fl["n"], fl["f"], fl["first"], fl["ipd"]
    n_flows, want, total = len(n), int(mix["packets"]), len(f)
    start = rng.uniform(0, float(mix["duration_s"]) * 1e6 * 0.5,
                        n_flows).astype(np.int64)
    cum = np.cumsum(ipd)
    ts = start[f] + cum - np.repeat(cum[first], n)
    tup = {"src_ip": rng.integers(1, 2**31, n_flows),
           "dst_ip": rng.integers(1, 2**31, n_flows),
           "src_port": rng.integers(1024, 65535, n_flows),
           "dst_port": rng.integers(1, 1024, n_flows),
           "proto": np.where(rng.random(n_flows) < 0.8, 6, 17)}
    if total < want:
        raise ValueError(f"the mix makes {total} packets, fewer than the "
                         f"{want} a capture holds")
    order = np.lexsort((np.arange(total), ts))[:want]
    fo = f[order]
    out = {k: v[fo].astype(np.uint32) for k, v in tup.items()}
    out["ts_us"] = (ts[order] % (2**31 - 1)).astype(np.int32)
    out["pkt_len"] = fl["lens"][order].astype(np.int32)
    out["windows"] = fl["feats"][_window_rows(first, n)[1][
        :int(mix.get("calib", 512))]]
    return out


def _window_rows(first, n, win=9, stride=7):
    """Feature windows of ``win`` packets, every ``stride`` packets of
    each flow in turn: (the flow of each window, its packets' rows
    [windows, win])."""
    ends = [np.arange(lo + win - 1, lo + ln, stride)
            for lo, ln in zip(first, n)]
    flow = np.repeat(np.arange(len(n)), [len(e) for e in ends])
    ends = np.concatenate(ends)
    return flow, ends[:, None] + np.arange(1 - win, 1)


def make_training_windows(mix: Dict, seed: int, win: int = 9):
    """A training set from the mix's flows: every ``win``-packet window
    of each flow (stride 7, as the calibration windows), its flow's
    class, and the inverse-frequency class weights of the paper's §6
    (as ``data/synthetic_traffic.class_weights``).  Returns (windows
    [N, win, 2] int32, labels [N] int64, weights [N] float32)."""
    fl = _draw_flows(mix, np.random.default_rng(seed & SEED_MASK))
    flow, rows = _window_rows(fl["first"], fl["n"], win)
    y = fl["label"][flow].astype(np.int64)
    k = len(mix["classes"])
    cnt = np.bincount(y, minlength=k).astype(np.float64)
    w = np.where(cnt > 0, len(y) / (k * np.maximum(cnt, 1)), 0.0)
    return fl["feats"][rows], y, w[y].astype(np.float32)


def make_captures(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The run's ``mix["captures"]`` distinct captures, in replay order."""
    rng = np.random.default_rng(seed & SEED_MASK)
    return [make_capture(mix, rng) for _ in range(int(mix["captures"]))]


def stream_of(capture: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The packet stream a replay takes (no calibration windows)."""
    return {k: v for k, v in capture.items() if k != "windows"}


def float_shapes(cfg: Dict) -> Dict[str, tuple]:
    """The float model's leaves by name, as the program names them, and
    their shapes."""
    e, k = cfg["embed_dim"], cfg["num_classes"]
    shapes = {"embed_len/table": (cfg["len_buckets"], e),
              "embed_ipd/table": (cfg["ipd_buckets"], e)}
    c = 2 * e
    if cfg["kind"] == "cnn":
        for i, ch in enumerate(cfg["conv_filters"]):
            shapes[f"conv{i}/w"] = (cfg["conv_kernel"], c, ch)
            shapes[f"conv{i}/b"] = (ch,)
            c = ch
        for i, fc in enumerate(cfg["fc_dims"]):
            shapes[f"fc{i}/w"] = (c, fc)
            shapes[f"fc{i}/b"] = (fc,)
            c = fc
    else:
        u = cfg["rnn_units"]
        shapes.update({"cell/wx": (c, u), "cell/wh": (u, u),
                       "cell/b": (u,)})
        c = u
    shapes.update({"head/w": (c, k), "head/b": (k,)})
    return shapes


def make_float_params(cfg: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    """Seeded float32 initial weights of the configuration on ``dev``:
    every matrix normal at 1/sqrt(fan-in) (fan-in the product of all but
    the last dimension), the embedding tables normal at 0.5, biases
    zero; the normals drawn in one call."""
    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed & SEED_MASK)
    shapes = float_shapes(cfg)
    mats = {k: s for k, s in shapes.items() if len(s) > 1}
    sizes = [math.prod(s) for s in mats.values()]
    flat = torch.randn((sum(sizes),), generator=g, device=dev,
                       dtype=torch.float32)
    out = {}
    for (k, s), v in zip(mats.items(), torch.split(flat, sizes)):
        scale = 0.5 if k.startswith("embed") else math.prod(s[:-1]) ** -0.5
        out[k] = (v * scale).view(s)
    return {k: out[k] if k in out else torch.zeros(s, device=dev)
            for k, s in shapes.items()}


def _shift_to(q: float, target: float, ceil: bool) -> int:
    v = math.log2(max(q, 1.0) / target)
    return max(0, math.ceil(v) if ceil else round(v))


def _q99(t: torch.Tensor) -> float:
    return float(torch.quantile(t.abs().to(torch.float32).reshape(-1),
                                0.99))


def make_weights(cfg: Dict, seed: int, calib: np.ndarray, dev
                 ) -> Dict:
    """Seeded int8 weights of the configuration in the plain numpy
    layout ([K, N] GEMM weights, int32 biases, int shifts), the int8
    draws made on ``dev`` in one call."""
    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed & SEED_MASK)
    e = cfg["embed_dim"]
    shapes = {"embed_len/table": (cfg["len_buckets"], e),
              "embed_ipd/table": (cfg["ipd_buckets"], e)}
    if cfg["kind"] == "cnn":
        c_prev = 2 * e
        for i, ch in enumerate(cfg["conv_filters"]):
            shapes[f"conv{i}/w"] = (cfg["conv_kernel"], c_prev, ch)
            c_prev = ch
        for i, fc in enumerate(cfg["fc_dims"]):
            shapes[f"fc{i}/w"] = (c_prev, fc)
            c_prev = fc
    else:
        shapes["cell/wx"] = (2 * e, cfg["rnn_units"])
        shapes["cell/wh"] = (cfg["rnn_units"], cfg["rnn_units"])
        c_prev = cfg["rnn_units"]
    shapes["head/w"] = (c_prev, cfg["num_classes"])
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randint(-127, 128, (sum(sizes),), generator=g, device=dev,
                         dtype=torch.int8)
    outs = [s[-1] for k, s in shapes.items() if not k.startswith(
        ("embed", "cell/wh", "head"))]
    unif = torch.rand((sum(outs),), generator=g, device=dev,
                      dtype=torch.float64)
    w = dict(zip(shapes, (p.view(s) for p, s in
                          zip(torch.split(flat, sizes), shapes.values()))))
    ids = bucketize(cfg, torch.from_numpy(calib).to(dev))
    x = torch.cat([w["embed_len/table"][ids[..., 0]],
                   w["embed_ipd/table"][ids[..., 1]]], dim=-1)
    qp: Dict = {k: w[k] for k in ("embed_len/table", "embed_ipd/table")}
    draws = iter(torch.split(unif, outs))

    def bias(acc: torch.Tensor) -> torch.Tensor:
        """The layer's biases, uniform in [-m, m], m the median
        |accumulator| on the batch."""
        m = int(acc.abs().median()) + 1
        u = next(draws)
        return (torch.floor(u * (2 * m + 1)) - m).to(torch.int32)

    if cfg["kind"] == "cnn":
        for i in range(len(cfg["conv_filters"])):
            name = f"conv{i}"
            wt = w[f"{name}/w"]
            kk, cin, cout = wt.shape
            b, n = x.shape[:2]
            pad = kk // 2
            xp = torch.nn.functional.pad(x, (0, 0, pad, kk - 1 - pad))
            cols = torch.stack([xp[:, j:j + n] for j in range(kk)],
                               dim=2).reshape(b * n, kk * cin)
            wm = wt.reshape(kk * cin, cout)
            acc = matmul_int8(cols, wm)
            qp[f"{name}/b"] = bias(acc)
            acc = acc + qp[f"{name}/b"]
            qp[f"{name}/w"] = wt
            qp[f"{name}/shift"] = _shift_to(_q99(acc), 64.0, True)
            x = torch.clamp_min(matmul_int8(cols, wm, qp[f"{name}/b"],
                                            qp[f"{name}/shift"]),
                                0).reshape(b, n, cout)
        qp["pool/mult"] = int(round((1 << 15) / cfg["seq_len"]))
        xs = x.to(torch.int32).sum(dim=1, dtype=torch.int32)
        x = ((xs * qp["pool/mult"]) >> 15).to(torch.int8)
        for i in range(len(cfg["fc_dims"])):
            name = f"fc{i}"
            acc = matmul_int8(x, w[f"{name}/w"])
            qp[f"{name}/b"] = bias(acc)
            qp[f"{name}/w"] = w[f"{name}/w"]
            qp[f"{name}/shift"] = _shift_to(_q99(acc + qp[f"{name}/b"]),
                                            64.0, True)
            x = torch.clamp_min(matmul_int8(x, w[f"{name}/w"],
                                            qp[f"{name}/b"],
                                            qp[f"{name}/shift"]), 0)
        h = x
    else:
        h = _calibrate_rnn(cfg, w, x.transpose(0, 1), qp, bias)
    acc = matmul_int8(h, w["head/w"])
    qp["head/w"] = w["head/w"]
    # centre each class's logit on the calibration batch
    qp["head/b"] = (-acc.to(torch.float64).mean(dim=0)).round() \
        .to(torch.int32)
    qp["head/shift"] = 0
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in qp.items()}


def _calibrate_rnn(cfg, w, x, qp, bias) -> torch.Tensor:
    """The RNN cell's bias, shifts and tanh LUT: each GEMM's 99th
    percentile |accumulator| near 512 after its shift, the LUT index's
    near 32 (tanh(2)); returns h after the window."""
    u, steps = cfg["rnn_units"], cfg["seq_len"]
    wx, wh = w["cell/wx"], w["cell/wh"]
    accx = torch.stack([matmul_int8(x[t], wx) for t in range(steps)])
    qp["cell/b"] = bias(accx)
    accx = accx + qp["cell/b"]
    sx = _shift_to(_q99(accx), 512.0, False)
    idx = torch.arange(-256, 256, device=x.device, dtype=torch.float64)
    lut = torch.clamp(torch.round(torch.tanh(idx / 16) * 128), -127,
                      127).to(torch.int8)

    def recur(sh, lp):
        h = torch.zeros((x.shape[1], u), dtype=torch.int8, device=x.device)
        ah, pr = [], []
        for t in range(steps):
            acch = matmul_int8(h, wh)
            pre = (accx[t] >> sx) + (acch >> sh)
            h = lut[(torch.clamp(pre >> lp, -256, 255) + 256).long()]
            ah.append(acch)
            pr.append(pre)
        return h, torch.stack(ah), torch.stack(pr)

    sh, lp = 0, _shift_to(_q99(accx >> sx), 32.0, False)
    for _ in range(3):              # the shifts and h settle together
        _, acch, pre = recur(sh, lp)
        sh, lp = _shift_to(_q99(acch), 512.0, False), \
            _shift_to(_q99(pre), 32.0, False)
    h, _, _ = recur(sh, lp)
    qp.update({"cell/wx": wx, "cell/wh": wh, "tanh_lut": lut,
               "cell/shift_x": sx, "cell/shift_h": sh,
               "cell/lut_preshift": lp})
    return h
