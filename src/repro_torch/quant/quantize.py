"""Post-training INT8 fixed-point quantization of the traffic models,
and their integer-only inference (paper §6).

Port of ``repro/quant/quantize.py``.  Power-of-two scales everywhere: an
activation x is held as x_q = round(x * 2^sa) int8, a weight as w_q =
round(w * 2^sw); a layer's int32 accumulator carries scale 2^(sa_in+sw)
and is requantized to the next activation grid by one right shift.
``quantize_traffic`` picks each grid from the absmax at every site of a
float forward over a calibration batch (``_collect_activations``, on the
params' device) and does the rest in numpy, as the reference does; it
returns the reference's numpy layout (the checkpoint form, which
``serving.qparams_from_numpy`` turns into the serving model).

``int8_apply`` runs the integer path, both branches, every GEMM on
``kernels/int8_matmul``:

* CNN: embedding gather, im2col conv layers with ReLU, an integer mean
  pool ``(sum * mult) >> 15``, the FC layers and the int32 head;
* RNN (the paper's FENIX-RNN): embedding gather, then per step of the
  window ``pre = ((x_t @ wx + b) >> shift_x) + ((h @ wh) >> shift_h)``
  (two raw int32 GEMMs; a shift of 0 is none), ``h = tanh_lut[clip(pre
  >> lut_preshift, -256, 255) + 256]`` (int8), and the int32 head on the
  last ``h``: 2 x seq_len + 1 GEMMs a call.  A ``lut_preshift`` <= 0
  is applied as the reference applies it: ``>>`` by a negative count
  sign-fills (-1 for a negative value, 0 otherwise), in PyTorch on the
  CPU and on CUDA as in XLA.

``qp`` is the port's integer model (``serving.qparams_from_numpy``):
int8/int32 tensors for weights, biases and tables, Python ints for the
per-layer shifts and the pool multiplier, so no shift is read back from
the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.fenix_models import TrafficModelConfig
from repro_torch.kernels.int8_matmul.ops import int8_conv1d, int8_matmul
from repro_torch.models import traffic

I32 = torch.int32


def _shift_for(absmax: float) -> int:
    """Largest s with absmax * 2^s <= 127 (decimal point position)."""
    absmax = max(float(absmax), 1e-8)
    return int(np.floor(np.log2(127.0 / absmax)))


def _q(x: np.ndarray, shift: int, dtype=np.int8) -> np.ndarray:
    lim = 127 if dtype == np.int8 else 2**31 - 1
    return np.clip(np.round(np.asarray(x, np.float64) * (1 << shift)
                            if shift >= 0 else
                            np.asarray(x, np.float64) / (1 << -shift)),
                   -lim, lim).astype(dtype)


def quantize_array(x: np.ndarray, shift: int, dtype=np.int8) -> np.ndarray:
    """Fixed-point quantize: ``round(x * 2^shift)`` saturated to dtype
    (``shift`` is the decimal-point position; negative shifts divide)."""
    return _q(x, shift, dtype)


def dequantize_array(x_q: np.ndarray, shift: int) -> np.ndarray:
    """Inverse grid map: ``x_q * 2^-shift`` (float64)."""
    return np.asarray(x_q, np.float64) * (2.0 ** -shift)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.array(t)


@torch.no_grad()
def _collect_activations(params: Dict, cfg: TrafficModelConfig,
                         payloads: torch.Tensor) -> Dict[str, float]:
    """Float forward, recording absmax at every quantization site."""
    sites: Dict[str, float] = {}

    def rec(name, x):
        sites[name] = max(sites.get(name, 0.0),
                          float(torch.max(torch.abs(x))))
        return x

    ids = traffic.bucketize(payloads, cfg)
    x = rec("embed", traffic.embed_ids(params, ids))
    if cfg.kind == "cnn":
        for i in range(len(cfg.conv_filters)):
            x = rec(f"conv{i}", torch.relu(traffic._conv1d(
                x, params[f"conv{i}/w"], params[f"conv{i}/b"])))
        x = rec("pool", torch.mean(x, dim=1))
        for i in range(len(cfg.fc_dims)):
            x = rec(f"fc{i}", torch.relu(
                x @ params[f"fc{i}/w"] + params[f"fc{i}/b"]))
        rec("head", x @ params["head/w"] + params["head/b"])
    else:
        h = torch.zeros((x.shape[0], cfg.rnn_units), dtype=x.dtype,
                        device=x.device)
        pres = []
        for t in range(x.shape[1]):
            pre = x[:, t] @ params["cell/wx"] + h @ params["cell/wh"] \
                + params["cell/b"]
            h = torch.tanh(pre)
            pres.append(pre)
        rec("cell_pre", torch.stack(pres))
        rec("cell", h)
        rec("head", h @ params["head/w"] + params["head/b"])
    return sites


def quantize_traffic(params: Dict, cfg: TrafficModelConfig,
                     calib_payloads) -> Dict:
    """The integer model, in the reference's numpy layout: int8
    weights/tables, int32 biases, per-layer shifts as 0-d int32 arrays,
    ``cfg_shifts`` a dict of them.  ``params`` are the float params
    (tensors on any device, or arrays); the calibration forward runs on
    their device."""
    first = next(iter(params.values()))
    dev = first.device if isinstance(first, torch.Tensor) else "cpu"
    params = {k: _np(v) for k, v in params.items()}
    sites = _collect_activations(
        {k: torch.from_numpy(v).to(dev) for k, v in params.items()}, cfg,
        torch.from_numpy(_np(calib_payloads)).to(dev))
    sa: Dict[str, int] = {k: min(_shift_for(v), 12)
                          for k, v in sites.items()}
    qp: Dict = {"cfg_shifts": sa}

    def qlayer(name, w, b, sa_in, sa_out):
        sw = min(_shift_for(np.max(np.abs(w))), 12)
        qp[f"{name}/w"] = _q(w, sw)
        qp[f"{name}/b"] = _q(b, sa_in + sw, np.int32)
        shift = sa_in + sw - sa_out
        if shift < 0:
            raise ValueError(f"{name}: negative requantization shift "
                             f"{shift} (sa_in {sa_in}, sw {sw}, sa_out "
                             f"{sa_out})")
        qp[f"{name}/shift"] = shift

    se = sa["embed"]
    qp["embed_len/table"] = _q(params["embed_len/table"], se)
    qp["embed_ipd/table"] = _q(params["embed_ipd/table"], se)
    if cfg.kind == "cnn":
        prev = "embed"
        for i in range(len(cfg.conv_filters)):
            qlayer(f"conv{i}", params[f"conv{i}/w"], params[f"conv{i}/b"],
                   sa[prev], sa[f"conv{i}"])
            prev = f"conv{i}"
        # integer mean over T: (sum * mult) >> 15, then rescale to pool grid
        sa["pool"] = sa[prev]
        qp["pool/mult"] = np.int32(round((1 << 15) / cfg.seq_len))
        prev = "pool"
        for i in range(len(cfg.fc_dims)):
            qlayer(f"fc{i}", params[f"fc{i}/w"], params[f"fc{i}/b"],
                   sa[prev], sa[f"fc{i}"])
            prev = f"fc{i}"
        qlayer("head", params["head/w"], params["head/b"], sa[prev],
               max(sa["head"], 0))
    else:
        # RNN: both matmuls accumulate on the cell_pre grid
        sa_pre = sa["cell_pre"]
        sh = sa["cell"]
        swx = min(_shift_for(np.max(np.abs(params["cell/wx"]))), 12)
        swh = min(_shift_for(np.max(np.abs(params["cell/wh"]))), 12)
        qp["cell/wx"] = _q(params["cell/wx"], swx)
        qp["cell/wh"] = _q(params["cell/wh"], swh)
        qp["cell/b"] = _q(params["cell/b"], sa["embed"] + swx, np.int32)
        qp["cell/shift_x"] = sa["embed"] + swx - sa_pre
        qp["cell/shift_h"] = sh + swh - sa_pre
        if qp["cell/shift_x"] < 0 or qp["cell/shift_h"] < 0:
            raise ValueError(f"cell: negative requantization shift "
                             f"{qp['cell/shift_x']}, {qp['cell/shift_h']}")
        # tanh LUT: index = clip(pre_q >> (sa_pre-4), -256, 255)
        idx = np.arange(-256, 256)
        lut_in = idx / (1 << 4)                      # pre at scale 2^-4
        qp["tanh_lut"] = _q(np.tanh(lut_in), sh)
        qp["cell/lut_preshift"] = sa_pre - 4
        qlayer("head", params["head/w"], params["head/b"], sh,
               max(sa["head"], 0))

    # the reference's jnp.asarray of each leaf: the 0-d ones as int32
    def leaf(v):
        return np.asarray(v, np.int32) if np.ndim(v) == 0 else v

    return {k: {kk: leaf(vv) for kk, vv in v.items()}
            if isinstance(v, dict) else leaf(v) for k, v in qp.items()}


# ---------------------------------------------------------------------------
# Integer-only inference (mirrors traffic.apply layer-for-layer)
# ---------------------------------------------------------------------------


def int8_apply(qp: Dict, cfg: TrafficModelConfig, payload: torch.Tensor,
               backend: Optional[str] = None,
               ipd_log2: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """payload [B,T,2] int32 -> logits [B,classes] int32."""
    ids = traffic.bucketize(payload, cfg, ipd_log2).long()
    if cfg.kind == "rnn":
        # the steps' inputs laid out once as [T, B, 2E], so each step's
        # GEMM operand x[t] is a contiguous [B, 2E] block (not a strided
        # view of [B, T, 2E]) and nothing is copied per step
        ids = ids.transpose(0, 1)
    el = qp["embed_len/table"][ids[..., 0]]
    ei = qp["embed_ipd/table"][ids[..., 1]]
    x = torch.cat([el, ei], dim=-1)                  # int8 [.,.,2E]
    if cfg.kind == "rnn":
        return _rnn(qp, cfg, x, backend)
    for i in range(len(cfg.conv_filters)):
        x = int8_conv1d(x, qp[f"conv{i}/w"], qp[f"conv{i}/b"],
                        int(qp[f"conv{i}/shift"]), backend=backend)
        x = torch.clamp_min(x, 0)                    # relu on the int8 grid
    xs = x.to(I32).sum(dim=1, dtype=I32)             # [B, C]
    x = ((xs * int(qp["pool/mult"])) >> 15).to(torch.int8)
    for i in range(len(cfg.fc_dims)):
        x = int8_matmul(x, qp[f"fc{i}/w"], qp[f"fc{i}/b"],
                        int(qp[f"fc{i}/shift"]), backend=backend)
        x = torch.clamp_min(x, 0)
    return int8_matmul(x, qp["head/w"], qp["head/b"], None, backend=backend)


def _rnn(qp: Dict, cfg: TrafficModelConfig, x: torch.Tensor,
         backend: Optional[str]) -> torch.Tensor:
    """The FENIX-RNN cell over x [T, B, 2E] int8 (contiguous), then the
    head: logits [B, classes] int32."""
    sx, sh = int(qp["cell/shift_x"]), int(qp["cell/shift_h"])
    pre_shift = int(qp["cell/lut_preshift"])
    lut = qp["tanh_lut"]
    h = torch.zeros((x.shape[1], cfg.rnn_units), dtype=torch.int8,
                    device=x.device)
    for t in range(x.shape[0]):
        accx = int8_matmul(x[t], qp["cell/wx"], qp["cell/b"], None,
                           backend=backend)
        acch = int8_matmul(h, qp["cell/wh"], None, None, backend=backend)
        pre = (accx >> sx if sx > 0 else accx) \
            + (acch >> sh if sh > 0 else acch)       # on the cell_pre grid
        lidx = torch.clamp(pre >> pre_shift, -256, 255)
        h = lut[(lidx + 256).long()]                 # int8 [B, U]
    return int8_matmul(h, qp["head/w"], qp["head/b"], None, backend=backend)
