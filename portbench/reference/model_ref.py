"""Plain PyTorch reference of the INT8 FENIX-CNN and FENIX-RNN (paper
§6): integer-only inference from a configuration's widths and its numpy
weights.

Every GEMM accumulates in float64, which is exact for int8 operands at
these depths (|acc| <= K * 127^2 < 2^53); bias and requantization run in
int32: a round-half-up ``>> shift`` saturated to [-127, 127].  The class
is the first maximal logit.  ``weight_bits=4`` serves the same model
with every weight and embedding rounded to the int4 grid (steps of 16 on
the int8 scale): the control that the comparison must refuse.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

I32 = torch.int32

# 1 + float32(ipd) values whose bucket follows the float32 log2 the
# model was specified with rather than the exponent of the value:
# (first, last, step, floor(log2))
_LOG2_EXCEPTIONS = (
    (8192, 8192, 1, 12), (32768, 32768, 1, 14),
    (2097151, 2097151, 1, 21), (4194303, 4194303, 1, 22),
    (8388601, 8388607, 1, 23), (16777201, 16777215, 1, 24),
    (33554418, 33554430, 2, 25), (67108864, 67108864, 1, 25),
    (134217728, 134217792, 16, 26), (268435216, 268435440, 16, 28),
    (536870688, 536870880, 32, 29), (1073741824, 1073741824, 1, 29),
    (2147483648, 2147483648, 1, 30),
)


def _log2_table(dev):
    f = np.concatenate([np.arange(a, b + 1, s, dtype=np.float64)
                        for a, b, s, _ in _LOG2_EXCEPTIONS])
    v = np.concatenate([np.full(len(range(a, b + 1, s)), lg)
                        for a, b, s, lg in _LOG2_EXCEPTIONS])
    keys = f.astype(np.float32).view(np.int32)
    order = np.argsort(keys)
    return (torch.from_numpy(keys[order]).to(dev),
            torch.from_numpy(v[order].astype(np.int32)).to(dev))


def bucketize(cfg: Dict, payload: torch.Tensor, log2=None) -> torch.Tensor:
    """payload [..., T, 2] int32 (length, delay in us) -> bucket ids
    [..., T, 2]: length >> 5, and 2 floor(log2(1 + float32(delay))),
    each clipped to its table."""
    ln = torch.clamp(payload[..., 0] >> 5, 0, cfg["len_buckets"] - 1)
    f = torch.clamp_min(payload[..., 1], 0).to(torch.float32) + 1.0
    bits = f.view(I32)
    lg = (bits >> 23) - 127
    keys, vals = log2 if log2 is not None else _log2_table(payload.device)
    pos = torch.clamp_max(torch.searchsorted(keys, bits), keys.shape[0] - 1)
    lg = torch.where(keys[pos] == bits, vals[pos], lg)
    ip = torch.clamp(2 * lg, 0, cfg["ipd_buckets"] - 1)
    return torch.stack([ln, ip], dim=-1).long()


def matmul_int8(a: torch.Tensor, b: torch.Tensor, bias=None, shift=None):
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(I32)
    if bias is not None:
        acc = acc + bias[None, :]
    if shift is None:
        return acc
    if shift > 0:
        acc = (acc + (1 << (shift - 1))) >> shift
    return torch.clamp(acc, -127, 127).to(torch.int8)


def _to_int4_grid(w: np.ndarray) -> np.ndarray:
    return (np.clip(np.round(w.astype(np.float64) / 16), -8, 7) * 16) \
        .astype(np.int8)


class ModelRef:
    """``cfg``: a configuration file's widths; ``qp``: numpy weights in
    plain [K, N] layout, shifts as ints."""

    def __init__(self, cfg: Dict, qp: Dict, dev, weight_bits: int = 8):
        if weight_bits not in (4, 8):
            raise ValueError(f"weight_bits {weight_bits}: 8 or 4")
        self.cfg = cfg
        self.dev = torch.device(dev)
        self.t = {}
        self.s = {}
        for k, v in qp.items():
            if isinstance(v, dict):
                continue
            if np.ndim(v) == 0:
                self.s[k] = int(v)
                continue
            a = np.asarray(v)
            if weight_bits == 4 and a.dtype == np.int8 and k != "tanh_lut":
                a = _to_int4_grid(a)
            self.t[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.log2 = _log2_table(self.dev)

    def logits(self, payload: torch.Tensor) -> torch.Tensor:
        """payload [B, T, 2] int32 -> logits [B, classes] int32."""
        c, t, s = self.cfg, self.t, self.s
        ids = bucketize(c, payload, self.log2)
        x = torch.cat([t["embed_len/table"][ids[..., 0]],
                       t["embed_ipd/table"][ids[..., 1]]], dim=-1)
        if c["kind"] == "rnn":
            return self._rnn(x)
        for i in range(len(c["conv_filters"])):
            w = t[f"conv{i}/w"]
            kk, cin, cout = w.shape
            b, n = x.shape[:2]
            pad = kk // 2
            xp = F.pad(x, (0, 0, pad, kk - 1 - pad))
            cols = torch.stack([xp[:, j:j + n] for j in range(kk)], dim=2)
            x = matmul_int8(cols.reshape(b * n, kk * cin),
                            w.reshape(kk * cin, cout), t[f"conv{i}/b"],
                            s[f"conv{i}/shift"]).reshape(b, n, cout)
            x = torch.clamp_min(x, 0)
        xs = x.to(I32).sum(dim=1, dtype=I32)
        x = ((xs * s["pool/mult"]) >> 15).to(torch.int8)
        for i in range(len(c["fc_dims"])):
            x = torch.clamp_min(matmul_int8(x, t[f"fc{i}/w"], t[f"fc{i}/b"],
                                            s[f"fc{i}/shift"]), 0)
        return matmul_int8(x, t["head/w"], t["head/b"])

    def _rnn(self, x: torch.Tensor) -> torch.Tensor:
        t, s = self.t, self.s
        sx, sh = s["cell/shift_x"], s["cell/shift_h"]
        lp = s["cell/lut_preshift"]
        h = torch.zeros((x.shape[0], self.cfg["rnn_units"]),
                        dtype=torch.int8, device=x.device)
        for step in range(x.shape[1]):
            ax = matmul_int8(x[:, step], t["cell/wx"], t["cell/b"])
            ah = matmul_int8(h, t["cell/wh"])
            pre = (ax >> sx if sx > 0 else ax) + (ah >> sh if sh > 0 else ah)
            h = t["tanh_lut"][(torch.clamp(pre >> lp, -256, 255)
                               + 256).long()]
        return matmul_int8(h, t["head/w"], t["head/b"])

    def classify(self, payload: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(payload), dim=-1).to(I32)
