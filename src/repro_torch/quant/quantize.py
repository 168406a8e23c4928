"""Integer-only inference of the quantized traffic models (§6).

Port of ``int8_apply`` from ``repro/quant/quantize.py``, CNN branch:
embedding gather, im2col conv layers with ReLU, an integer mean pool
``(sum * mult) >> 15``, the FC layers and the int32 head, every GEMM on
``kernels/int8_matmul``.  The RNN branch and the quantizer itself
(``quantize_traffic``) are not ported yet (ROADMAP).

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
    if cfg.kind != "cnn":
        raise NotImplementedError(
            f"int8_apply: the {cfg.kind!r} branch is not ported yet "
            "(ROADMAP.md, the int8_rnn slice)")
    ids = traffic.bucketize(payload, cfg, ipd_log2).long()
    el = qp["embed_len/table"][ids[..., 0]]
    ei = qp["embed_ipd/table"][ids[..., 1]]
    x = torch.cat([el, ei], dim=-1)                  # int8 [B,T,2E]
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
