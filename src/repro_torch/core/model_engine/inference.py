"""DNN Inference Module (§5.2): the quantized FENIX-CNN or FENIX-RNN
on the INT8 GEMM.

Port of ``EngineModel``, ``ByLenModel``, ``macs_per_inference`` and
``CycleModel`` from ``repro/core/model_engine/inference.py``.
``EngineModel`` is an ``nn.Module`` whose integer weights are buffers, so
``.to(device)`` moves the whole model; every GEMM it runs goes through
``kernels/int8_matmul`` on its ``backend``.  ``infer_engines`` serves a
stack of lane batches (the pipes' or the engines' of one step) in one
pass: one GEMM a layer over all of them.  ``card_latency_us`` is the
counterpart of the reference's ``tpu_latency_us``: the same roofline on
one H100.
"""

from __future__ import annotations

from typing import Dict, Optional

import dataclasses

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
    def num_classes(self) -> int:
        return self.cfg.num_classes

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

    def infer_engines(self, payload: torch.Tensor) -> torch.Tensor:
        """payload [E, B, T, 2] int32 -> class [E, B] int32: the E
        batches flattened into one (classes are per lane, so nothing
        changes), one GEMM a layer."""
        return _infer_stacked(self, payload)


def _infer_stacked(model, payload: torch.Tensor) -> torch.Tensor:
    e, b = payload.shape[:2]
    return model.infer(payload.reshape((e * b,) + payload.shape[2:])) \
        .view(e, b)


class ByLenModel:
    """Deterministic stand-in Model Engine: class = F9 pkt_len mod 7."""

    num_classes = 7

    def infer(self, payload: torch.Tensor) -> torch.Tensor:
        return (payload[:, -1, 0] % self.num_classes).to(I32)

    def infer_engines(self, payload: torch.Tensor) -> torch.Tensor:
        return _infer_stacked(self, payload)


def macs_per_inference(cfg: TrafficModelConfig) -> int:
    """Multiply-accumulates for one feature window (cycle model input)."""
    e = cfg.embed_dim
    d_in = 2 * e
    t = cfg.seq_len
    total = 0
    if cfg.kind == "cnn":
        c_prev = d_in
        for ch in cfg.conv_filters:
            total += t * cfg.conv_kernel * c_prev * ch
            c_prev = ch
        f_prev = c_prev
        for fc in cfg.fc_dims:
            total += f_prev * fc
            f_prev = fc
        total += f_prev * cfg.num_classes
    else:
        u = cfg.rnn_units
        total += t * (d_in * u + u * u)
        total += u * cfg.num_classes
    return total


@dataclasses.dataclass(frozen=True)
class CycleModel:
    """The FPGA's INT8 array: width x width MACs at f_clk, as the
    reference models it (a ZU19EG-style array)."""
    array_width: int = 32
    f_clk_hz: float = 300e6
    pipeline_fill_cycles: int = 64

    def latency_us(self, cfg: TrafficModelConfig) -> float:
        macs = macs_per_inference(cfg)
        cycles = macs / (self.array_width ** 2) + self.pipeline_fill_cycles
        return cycles / self.f_clk_hz * 1e6

    def throughput_inf_per_s(self, cfg: TrafficModelConfig) -> float:
        return self.f_clk_hz * self.array_width ** 2 \
            / macs_per_inference(cfg)

    def farm_throughput_inf_per_s(self, cfg: TrafficModelConfig,
                                  num_engines: int) -> float:
        """Aggregate service rate of ``num_engines`` independent engines
        (additive: no cross-engine pipeline)."""
        return num_engines * self.throughput_inf_per_s(cfg)

    def farm_batch_latency_us(self, cfg: TrafficModelConfig, batch: int,
                              num_engines: int) -> float:
        """Service latency of ``batch`` windows split across
        ``num_engines`` (ceil split): one fill + latency for the first,
        then one result per ``macs / width^2`` cycles."""
        per_engine = -(-batch // max(num_engines, 1))
        if per_engine <= 0:
            return 0.0
        macs = macs_per_inference(cfg)
        issue_us = macs / (self.array_width ** 2) / self.f_clk_hz * 1e6
        return self.latency_us(cfg) + (per_engine - 1) * issue_us


# NVIDIA H100 SXM, dense (data sheet): int8 tensor-core operations/s and
# HBM3 bytes/s
CARD_INT8_OPS_PER_S = 1979e12
CARD_HBM_BYTES_PER_S = 3.35e12


def card_latency_us(cfg: TrafficModelConfig, batch: int = 128) -> Dict:
    """Roofline latency of a window batch on one H100: the reference's
    ``tpu_latency_us`` formula at the card's rates.

    compute = MACs*2 / 1979 T int8 ops/s; memory = weight (~1 byte a
    unique MAC weight) + activation bytes / 3.35 TB/s.
    """
    macs = macs_per_inference(cfg) * batch
    flops = 2.0 * macs
    w_bytes = macs_per_inference(cfg)
    t_compute = flops / CARD_INT8_OPS_PER_S * 1e6
    t_memory = (w_bytes + batch * cfg.seq_len * 2 * 4) \
        / CARD_HBM_BYTES_PER_S * 1e6
    return {"compute_us": t_compute, "memory_us": t_memory,
            "latency_us": max(t_compute, t_memory)}
