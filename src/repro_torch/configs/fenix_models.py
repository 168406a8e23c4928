"""Configs of the paper's traffic-analysis models (§7.1 schemes a/b/d/e).

The port's own copy of ``repro/configs/fenix_models.py``:
FENIX-CNN has 3 conv layers (64, 128, 256 filters) and 2 FC layers
(512, 256); FENIX-RNN has embeddings, one custom RNN cell (128 units)
and a dense output.  Features are 9-step windows of packet lengths and
inter-packet delays (8 buffered + 1 current, paper §6).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TrafficModelConfig:
    name: str
    kind: str                       # "cnn" | "rnn"
    num_classes: int
    seq_len: int = 9                # ring depth 8 + current feature
    len_buckets: int = 64
    ipd_buckets: int = 64
    embed_dim: int = 16
    # CNN
    conv_filters: Tuple[int, ...] = (64, 128, 256)
    conv_kernel: int = 3
    fc_dims: Tuple[int, ...] = (512, 256)
    # RNN
    rnn_units: int = 128
    quant_bits: int = 8


def fenix_cnn(num_classes: int = 7) -> TrafficModelConfig:
    return TrafficModelConfig(name="fenix-cnn", kind="cnn",
                              num_classes=num_classes)


def fenix_rnn(num_classes: int = 7) -> TrafficModelConfig:
    return TrafficModelConfig(name="fenix-rnn", kind="rnn",
                              num_classes=num_classes)


def fenix_cnn_tiny(num_classes: int = 7) -> TrafficModelConfig:
    """CI-sized CNN: the paper model's layer structure, shrunk."""
    return TrafficModelConfig(name="fenix-cnn-tiny", kind="cnn",
                              num_classes=num_classes, embed_dim=4,
                              conv_filters=(8,), fc_dims=(16,))


def fenix_rnn_tiny(num_classes: int = 7) -> TrafficModelConfig:
    """CI-sized RNN counterpart of :func:`fenix_cnn_tiny`."""
    return TrafficModelConfig(name="fenix-rnn-tiny", kind="rnn",
                              num_classes=num_classes, embed_dim=4,
                              rnn_units=16)


# serving-model registry: the FenixConfig(model=...) names of quantized
# EngineModels ("bylen" is handled by the serving factory)
MODEL_CONFIGS = {
    "int8_cnn": fenix_cnn,
    "int8_rnn": fenix_rnn,
    "int8_cnn_tiny": fenix_cnn_tiny,
    "int8_rnn_tiny": fenix_rnn_tiny,
}


def model_config(name: str, num_classes: int = 7) -> TrafficModelConfig:
    """Resolve a ``FenixConfig.model`` name to its TrafficModelConfig."""
    if name not in MODEL_CONFIGS:
        raise ValueError(f"unknown model {name!r}; expected one of "
                         f"{('bylen',) + tuple(sorted(MODEL_CONFIGS))}")
    return MODEL_CONFIGS[name](num_classes)
