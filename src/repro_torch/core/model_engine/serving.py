"""Serving-model factory: train, quantize, checkpoint, and build the
Model Engine's DNN from one ``FenixConfig(model=...)`` name.

Port of ``repro/core/model_engine/serving.py``.  It closes the paper's
model loop (§6 "Model Training and Quantization" -> §5.2 "DNN Inference
Module"): the float traffic classifier (models/traffic.py) is trained on
trace-ingested flows (``synthetic_corpus`` writes a deterministic pcap
fixture and reads it back through the port's ingest path),
post-training-quantized to the INT8 fixed-point scheme
(quant/quantize.py), and wrapped in an ``EngineModel`` whose every GEMM
runs through ``kernels/int8_matmul``.

Model names (``FenixConfig.model``):

  ``"bylen"``          the deterministic stand-in (data-plane benchmarks)
  ``"int8_cnn"``       paper-sized FENIX-CNN, trained + quantized
  ``"int8_rnn"``       paper-sized FENIX-RNN, trained + quantized
  ``"int8_cnn_tiny"``  CI-sized CNN (same structure, shrunk; tests)
  ``"int8_rnn_tiny"``  CI-sized RNN

Quantized checkpoints: :func:`save_quantized` / :func:`load_quantized`
persist the integer model (int8 weights, per-layer shifts and the model
config) in train/checkpoint.py's layout, the reference's own, so either
side serves the other's.  ``FenixConfig(model_dir=...)`` serves straight
from one.  Without a ``model_dir`` the factory trains a default instance
on the synthetic fixture corpus and caches it per process (by name, task
and device type), so every system of a process serves the same weights.

The integer model moves between these functions in the reference's
numpy layout (``quantize_traffic``'s output, a checkpoint's content);
:func:`qparams_from_numpy` turns it into the serving model's tensors,
with the GEMM weights held K-major (``ops.k_major``), packed once at
load: the replay's launches are the same as with the reference's layout.
Every entry point runs on ``cuda`` unless the caller names another
device, and raises without CUDA.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import (DeviceLike, resolve_backend,
                                 resolve_device, validate_backend)
from repro_torch.baselines.common import confusion_matrix, macro_f1
from repro_torch.configs.fenix_models import (MODEL_CONFIGS,
                                              TrafficModelConfig,
                                              model_config)
from repro_torch.core.model_engine.inference import ByLenModel, EngineModel
from repro_torch.data.synthetic_traffic import (Flow, class_weights,
                                                make_flows, task_meta,
                                                windows_from_flows)
from repro_torch.kernels.int8_matmul.ops import k_major
from repro_torch.models import traffic
from repro_torch.quant.quantize import int8_apply, quantize_traffic
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, batch_iterator

SERVING_MODELS = ("bylen",) + tuple(sorted(MODEL_CONFIGS))

# CI-sized defaults for the in-process trained model (the reference's:
# they keep the test suite inside its time budget)
DEFAULT_TASK = "iscx"
DEFAULT_FLOWS = 240
DEFAULT_STEPS = 120
DEFAULT_SEED = 11


def synthetic_corpus(task: str = DEFAULT_TASK, n_flows: int = DEFAULT_FLOWS,
                     seed: int = DEFAULT_SEED,
                     pcap_path: Optional[str] = None) -> List[Flow]:
    """Deterministic stand-in corpus, routed through the ingest path:
    class-conditioned flows written as pcap bytes plus the ground-truth
    sidecar (``trace_ingest.synthesize_pcap``) and read back with
    ``trace_ingest.load_flows``.  ``pcap_path`` keeps the fixture; None
    uses a temporary file."""
    from repro_torch.data.trace_ingest import load_flows, synthesize_pcap

    flows = make_flows(task, n_flows, seed=seed, min_per_class=12)
    if pcap_path is None:
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, f"{task}_corpus.pcap")
            synthesize_pcap(flows, p)
            return load_flows(p)
    synthesize_pcap(flows, pcap_path)
    return load_flows(pcap_path)


def train_quantized(mcfg: TrafficModelConfig, flows: List[Flow],
                    steps: int = DEFAULT_STEPS, seed: int = 0,
                    batch: int = 256, lr: float = 3e-3,
                    ckpt_dir: Optional[str] = None, calib: int = 512,
                    device: DeviceLike = None) -> Tuple[Dict, Dict, Dict]:
    """Float-train on flow windows, then post-training-quantize to INT8.

    Returns ``(params, qparams, metrics)``: the float weights (tensors on
    ``device``), the integer model in the reference's numpy layout, and
    the final training metrics.  ``ckpt_dir`` threads through to the
    fault-tolerant trainer (auto-resume, NaN recovery); the first
    ``calib`` training windows calibrate the activation grids.  On CUDA
    the train step is a CUDA graph.
    """
    dev = resolve_device(device)
    x, y, _ = windows_from_flows(flows, seed=seed)
    w = class_weights(y, mcfg.num_classes)
    params = traffic.init(mcfg, seed=seed, device=dev)
    table = traffic.ipd_log2_table(dev)
    trainer = Trainer(
        lambda p, b: traffic.loss_fn(p, mcfg, b, table), params,
        TrainerConfig(total_steps=steps, log_every=10**9,
                      ckpt_dir=ckpt_dir,
                      opt=OptConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                                    total_steps=steps, weight_decay=0.01)),
        device=dev)
    metrics = trainer.run(batch_iterator(x, y, batch, seed=seed, weights=w,
                                         device=dev))
    qp = quantize_traffic(trainer.params, mcfg, x[:calib])
    return trainer.params, qp, metrics


# -- quantized checkpoints ---------------------------------------------------

def save_quantized(model_dir: str, qp: Dict, mcfg: TrafficModelConfig,
                   meta: Optional[Dict] = None) -> str:
    """Persist the integer model (the numpy layout): one atomic
    checkpoint step holding the quantized params plus the model config
    (restored by :func:`load_quantized`, here or by the reference)."""
    m = {"model_config": dataclasses.asdict(mcfg), **(meta or {})}
    return ckpt_lib.save(str(model_dir), 0, {"qparams": qp}, meta=m)


def load_quantized(model_dir) -> Tuple[Dict, TrafficModelConfig]:
    """Inverse of :func:`save_quantized` (or of the reference's) ->
    (qparams as numpy arrays, model config)."""
    restored = ckpt_lib.restore_latest(str(model_dir))
    if restored is None:
        raise FileNotFoundError(
            f"no quantized checkpoint under {str(model_dir)!r} "
            "(expected a serving.save_quantized layout)")
    state, meta = restored
    mc = dict(meta["model_config"])
    mc["conv_filters"] = tuple(mc["conv_filters"])
    mc["fc_dims"] = tuple(mc["fc_dims"])
    return state["qparams"], TrafficModelConfig(**mc)


def _is_gemm_weight(key: str) -> bool:
    layer, _, leaf = key.partition("/")
    if layer == "cell":                  # the RNN cell's two GEMM weights
        return leaf in ("wx", "wh")
    return leaf == "w" and (layer == "head"
                            or re.fullmatch(r"(conv|fc)\d+", layer)
                            is not None)


def qparams_from_numpy(qp: Dict, device=None) -> Dict:
    """The integer model in the reference's numpy layout
    (``quantize_traffic`` output or a loaded checkpoint) -> the port's
    serving form: the same keys, arrays as int8/int32 tensors on
    ``device``, 0-d entries (shifts, the pool multiplier, the RNN's
    ``cell/lut_preshift``) as Python ints, ``cfg_shifts`` nested as a
    dict of ints.

    The GEMM weights (``conv*/w`` [kk,Cin,Cout], ``fc*/w``, ``head/w``
    and the RNN cell's ``cell/wx`` [2E,U] and ``cell/wh`` [U,U]) keep
    their shapes and values but are views of K-major buffers
    (``ops.k_major``): the reduction dimension is contiguous, the layout
    the INT8 kernel reads, so each GEMM takes its weight as it is (a conv
    weight's [kk*Cin, Cout] reshape is a view).  The packing runs once
    here; it adds no launch to a replay."""
    out: Dict = {}
    for k, v in qp.items():
        if isinstance(v, dict):
            out[k] = {kk: int(np.asarray(vv)) for kk, vv in v.items()}
        elif np.ndim(v) == 0:
            out[k] = int(np.asarray(v))
        else:
            t = torch.from_numpy(np.array(v)).to(device)
            out[k] = k_major(t) if _is_gemm_weight(k) else t
    return out


# -- the FenixConfig(model=...) factory --------------------------------------

@functools.lru_cache(maxsize=None)
def _default_trained(name: str, task: str, device_type: str
                     ) -> Tuple[TrafficModelConfig, Dict]:
    """Train-and-quantize the default instance of a named model, once per
    process and device type (numpy qparams).  Cached so every FenixSystem
    of a process serves identical quantized weights."""
    mcfg = model_config(name, num_classes=len(task_meta(task)[0]))
    flows = synthetic_corpus(task)
    _, qp, _ = train_quantized(mcfg, flows, seed=DEFAULT_SEED,
                               device=device_type)
    return mcfg, qp


def build_model(name: str, matmul_backend: Optional[str] = None,
                model_dir=None, task: str = DEFAULT_TASK,
                device: DeviceLike = None):
    """Resolve ``FenixConfig(model=, matmul_backend=, model_dir=)`` to a
    serving model on ``device`` (``cuda`` unless the caller names
    another).

    ``"bylen"`` returns the deterministic stand-in (and rejects a
    ``matmul_backend``, which would silently do nothing).  The int8 names
    load a quantized checkpoint from ``model_dir`` when given, else the
    process-cached default trained on the synthetic fixture corpus (on
    ``device``); the resulting :class:`EngineModel` dispatches every GEMM
    through ``kernels/int8_matmul`` on the chosen backend."""
    dev = resolve_device(device)
    if name == "bylen":
        if matmul_backend is not None:
            raise ValueError(
                "matmul_backend selects the int8 GEMM backend; model "
                "'bylen' runs no GEMMs — pick an int8_* model or drop "
                "the knob")
        return ByLenModel()
    if name not in MODEL_CONFIGS:
        raise ValueError(f"unknown model {name!r}; expected one of "
                         f"{SERVING_MODELS}")
    validate_backend(matmul_backend, "matmul_backend")
    if model_dir is not None:
        qp, mcfg = load_quantized(model_dir)
    else:
        mcfg, qp = _default_trained(name, task, dev.type)
    return EngineModel(mcfg, qparams_from_numpy(qp, dev),
                       backend=matmul_backend)


def evaluate_quantized(qp: Dict, mcfg: TrafficModelConfig,
                       x: np.ndarray, y: np.ndarray,
                       backend: Optional[str] = None,
                       device: DeviceLike = None) -> Dict:
    """Window-level eval of an integer model (the numpy layout) on
    ``device``: macro-F1, confusion and predictions.  ``backend`` is the
    ``matmul_backend`` (the kernel on CUDA by default, the plain version
    on the CPU).

    The verification half of the >90% claim: the confusion matrix shows
    whether the F1 rides one majority class."""
    dev = resolve_device(device)
    payload = torch.as_tensor(np.asarray(x, np.int32)).to(dev)
    backend = resolve_backend(backend, payload, "matmul_backend")
    logits = int8_apply(qparams_from_numpy(qp, dev), mcfg, payload,
                        backend=backend)
    pred = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
    return {"macro_f1": macro_f1(y, pred, mcfg.num_classes),
            "confusion": confusion_matrix(y, pred,
                                          mcfg.num_classes).tolist(),
            "pred": pred}
