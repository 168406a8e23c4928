"""DNN Inference Module (§5.2): the quantized FENIX-CNN or FENIX-RNN
on the INT8 GEMM.

Port of ``EngineModel`` and ``ByLenModel`` from
``repro/core/model_engine/inference.py``.  ``EngineModel`` is an
``nn.Module`` whose integer weights are buffers, so ``.to(device)``
moves the whole model; every GEMM it runs goes through
``kernels/int8_matmul`` on its ``backend``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch._device import validate_backend
from repro_torch.configs.fenix_models import TrafficModelConfig
from repro_torch.models.traffic import ipd_log2_table
from repro_torch.quant.quantize import int8_apply

I32 = torch.int32


def _buffer_name(key: str) -> str:
    return "q_" + key.replace("/", "__")


class EngineModel(nn.Module):
    """A quantized traffic model (``cfg.kind`` "cnn" or "rnn") serving
    on the INT8 GEMM.

    ``qparams``: the port's integer model (``serving.qparams_from_numpy``)
    — tensors become buffers, the shifts stay Python ints.  ``backend``
    is the ``matmul_backend`` knob: "cuda", "ref" or None (the kernel on
    CUDA tensors, the plain version on CPU ones).
    """

    def __init__(self, cfg: TrafficModelConfig, qparams: Dict,
                 backend: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.backend = validate_backend(backend, "matmul_backend")
        self._tensor_keys = [k for k, v in qparams.items()
                             if isinstance(v, torch.Tensor)]
        self._scalars = {k: v for k, v in qparams.items()
                         if not isinstance(v, torch.Tensor)}
        for k in self._tensor_keys:
            self.register_buffer(_buffer_name(k), qparams[k])
        dev = qparams[self._tensor_keys[0]].device
        keys, vals = ipd_log2_table(dev)
        self.register_buffer("ipd_log2_keys", keys)
        self.register_buffer("ipd_log2_vals", vals)

    @property
    def qparams(self) -> Dict:
        qp = dict(self._scalars)
        qp.update({k: getattr(self, _buffer_name(k))
                   for k in self._tensor_keys})
        return qp

    def with_backend(self, backend: Optional[str]) -> "EngineModel":
        """The same weights (shared, not copied) on another backend."""
        return EngineModel(self.cfg, self.qparams, backend=backend)

    def infer(self, payload: torch.Tensor) -> torch.Tensor:
        """payload [B, T, 2] int32 -> class [B] int32 (first maximal
        logit, as jnp.argmax)."""
        logits = int8_apply(self.qparams, self.cfg, payload,
                            backend=self.backend,
                            ipd_log2=(self.ipd_log2_keys,
                                      self.ipd_log2_vals))
        return torch.argmax(logits, dim=-1).to(I32)


class ByLenModel:
    """Deterministic stand-in Model Engine: class = F9 pkt_len mod 7."""

    num_classes = 7

    def infer(self, payload: torch.Tensor) -> torch.Tensor:
        return (payload[:, -1, 0] % self.num_classes).to(I32)
