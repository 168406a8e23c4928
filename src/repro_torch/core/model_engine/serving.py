"""Serving-model factory: carry the reference's quantized weights
across and build the Model Engine's DNN from a ``FenixConfig(model=)``
name.

Port of the serving half of ``repro/core/model_engine/serving.py``:
``qparams_from_numpy``, ``load_quantized`` (numpy only: the reference's
``train/checkpoint.py`` layout is ``step_XXXXXXXX/state.npz`` with
``␟``-joined keys plus ``meta.json``) and ``build_model``.  Training and
quantization are not ported yet: an int8 model is served from a
checkpoint directory (or from weights handed in by the caller).  The
GEMM weights are held K-major from here on (``qparams_from_numpy``),
packed once at load: the replay's launches are the same as with the
reference's layout.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import validate_backend
from repro_torch.configs.fenix_models import (MODEL_CONFIGS,
                                              TrafficModelConfig)
from repro_torch.core.model_engine.inference import ByLenModel, EngineModel
from repro_torch.kernels.int8_matmul.ops import k_major

SERVING_MODELS = ("bylen",) + tuple(sorted(MODEL_CONFIGS))
_SEP = "␟"
_SENTINEL = "COMPLETE"


def _is_gemm_weight(key: str) -> bool:
    layer, _, leaf = key.partition("/")
    if layer == "cell":                  # the RNN cell's two GEMM weights
        return leaf in ("wx", "wh")
    return leaf == "w" and (layer == "head"
                            or re.fullmatch(r"(conv|fc)\d+", layer)
                            is not None)


def qparams_from_numpy(qp: Dict, device=None) -> Dict:
    """The reference's quantized params (``quantize_traffic`` output or a
    loaded checkpoint, as numpy arrays) -> the port's integer model: the
    same keys, arrays as int8/int32 tensors on ``device``, 0-d entries
    (shifts, the pool multiplier, the RNN's ``cell/lut_preshift``) as
    Python ints, ``cfg_shifts`` nested as a dict of ints.

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


def _latest_step(model_dir: Path) -> Optional[Path]:
    steps = sorted(d for d in model_dir.glob("step_*")
                   if d.is_dir() and not d.name.endswith(".tmp")
                   and (d / _SENTINEL).exists())
    return steps[-1] if steps else None


def load_quantized(model_dir) -> Tuple[Dict, TrafficModelConfig]:
    """Read a reference ``save_quantized`` checkpoint with numpy alone ->
    (qparams as numpy arrays, model config)."""
    step = _latest_step(Path(model_dir))
    if step is None:
        raise FileNotFoundError(
            f"no quantized checkpoint under {str(model_dir)!r} "
            "(expected a serving.save_quantized layout)")
    tree: Dict = {}
    with np.load(step / "state.npz") as data:
        for key in data.files:
            *parents, leaf = key.split(_SEP)
            cur = tree
            for p in parents:
                cur = cur.setdefault(p, {})
            cur[leaf] = data[key]
    meta = json.loads((step / "meta.json").read_text())
    mc = dict(meta["model_config"])
    mc["conv_filters"] = tuple(mc["conv_filters"])
    mc["fc_dims"] = tuple(mc["fc_dims"])
    return tree["qparams"], TrafficModelConfig(**mc)


def build_model(name: str, matmul_backend: Optional[str] = None,
                model_dir=None, device=None):
    """Resolve ``FenixConfig(model=, matmul_backend=, model_dir=)`` to a
    serving model on ``device``.  The int8 names need ``model_dir``:
    training is not ported yet."""
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
    if model_dir is None:
        raise NotImplementedError(
            f"model {name!r} needs model_dir=: training and quantization "
            "are not ported yet (ROADMAP.md, the training slice); serve a "
            "checkpoint written by repro.core.model_engine.serving."
            "save_quantized, or pass an EngineModel")
    qp, mcfg = load_quantized(model_dir)
    return EngineModel(mcfg, qparams_from_numpy(qp, device),
                       backend=matmul_backend)
