"""INT8 gradient compression with error feedback.

Port of ``repro/distributed/compression.py``.  Before a data-parallel
all-reduce each gradient tensor is quantized to int8 with a per-tensor
scale, and the quantization residual is carried into the next step
(error feedback), which preserves SGD's convergence.  The round trip
quantize -> dequantize (``compress_decompress``) is what the trainer
runs under ``TrainerConfig(grad_compression=True)``; the all-reduce and
the rest of ``distributed/`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass
class CompressedState:
    error: Dict[str, torch.Tensor]

    @staticmethod
    def init(params: Dict[str, Any]) -> "CompressedState":
        return CompressedState(
            error={k: torch.zeros(v.shape, dtype=F32, device=v.device)
                   for k, v in params.items()})


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_decompress(grads: Dict[str, torch.Tensor],
                        state: CompressedState
                        ) -> Tuple[Dict[str, torch.Tensor], CompressedState]:
    """Error-feedback int8 round trip applied per tensor."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        g32 = g.to(F32) + state.error[k]
        q, scale = quantize_grad(g32)
        deq = dequantize_grad(q, scale)
        new_g[k] = deq.to(g.dtype)
        new_e[k] = g32 - deq
    return new_g, CompressedState(error=new_e)
