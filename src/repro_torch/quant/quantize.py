"""Integer-only inference of the quantized traffic models (§6).

Port of ``int8_apply`` from ``repro/quant/quantize.py``, both branches,
every GEMM on ``kernels/int8_matmul``:

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

The quantizer itself (``quantize_traffic``) is not ported yet (ROADMAP).

``qp`` is the port's integer model (``serving.qparams_from_numpy``):
int8/int32 tensors for weights, biases and tables, Python ints for the
per-layer shifts and the pool multiplier, so no shift is read back from
the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.fenix_models import TrafficModelConfig
from repro_torch.kernels.int8_matmul.ops import int8_conv1d, int8_matmul
from repro_torch.models import traffic

I32 = torch.int32


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
