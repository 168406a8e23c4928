"""BoS [NSDI'24] baseline: binarized GRU on the switch.

Port of ``repro/baselines/bos.py``.  Per §7.1(h): the largest BoS
variant — binarized GRU weights (+-1 via straight-through estimator),
6-bit embeddings, 9-bit fixed-point hidden states, 8 GRU units,
embedding->GRU->output structure.  The binarization and the tiny hidden
width are exactly what costs BoS accuracy vs FENIX's
full-precision-trained INT8 models (Table 2 analysis).

The straight-through estimators are ported op for op: ``w + (sign(w) -
w).detach()`` is not always exactly +-1 in float32, and ``torch.round``
rounds half to even as ``jnp.round`` does.  The reference's ``lax.scan``
over the window's steps is a Python loop.  The gates' sigmoid is
``layers.sigmoid``, ``jax.nn.sigmoid``'s ``1 / (1 + exp(-x))`` op for op
(as the LM's); ``tanh`` is torch's.  Each float32 library call still
rounds some outputs to the other neighbour of JAX's (``exp``, and XLA's
rational ``tanh``), and the products sum in another order, so logits and
losses agree within the tolerances tests/test_torch_baselines.py states,
not bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.fenix_models import TrafficModelConfig
from repro_torch.models import traffic
from repro_torch.models.layers import sigmoid
from repro_torch.models.param import Registrar

F32 = torch.float32
_UNITS = 8
_EMB_BITS = 6
_HID_BITS = 9

IpdTable = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _binarize_ste(w: torch.Tensor) -> torch.Tensor:
    """sign(w) with straight-through gradient."""
    return w + (torch.sign(w) - w).detach()


def _quant_ste(x: torch.Tensor, bits: int, amax: float) -> torch.Tensor:
    scale = (2 ** (bits - 1) - 1) / amax
    q = torch.clamp(torch.round(x * scale), -(2 ** (bits - 1) - 1),
                    2 ** (bits - 1) - 1) / scale
    return x + (q - x).detach()


def init(cfg: TrafficModelConfig, seed: int = 0,
         device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The float32 params on ``device`` (``cuda`` unless the caller names
    another), bit for bit the reference's."""
    reg = Registrar(abstract=False, seed=seed, dtype=F32,
                    device=resolve_device(device))
    e = cfg.embed_dim
    reg.param("embed_len/table", (cfg.len_buckets, e), ("vocab", "embed"),
              scale=0.5, dtype=F32)
    reg.param("embed_ipd/table", (cfg.ipd_buckets, e), ("vocab", "embed"),
              scale=0.5, dtype=F32)
    d_in = 2 * e
    for nm, shape in (("wz", (d_in + _UNITS, _UNITS)),
                      ("wr", (d_in + _UNITS, _UNITS)),
                      ("wh", (d_in + _UNITS, _UNITS))):
        reg.param(f"gru/{nm}", shape, ("embed", "ffn"),
                  scale=shape[0] ** -0.5, dtype=F32)
    reg.param("head/w", (_UNITS, cfg.num_classes), ("embed", "classes"),
              scale=_UNITS ** -0.5, dtype=F32)
    reg.param("head/b", (cfg.num_classes,), ("classes",), init="zeros",
              dtype=F32)
    return reg.params


def apply(params: Dict, cfg: TrafficModelConfig, payload: torch.Tensor,
          ipd_log2: IpdTable = None) -> torch.Tensor:
    """payload [B,T,2] int32 -> logits [B,classes].  ``ipd_log2`` as in
    ``traffic.bucketize`` (a captured train step must be given it:
    building it copies from the host)."""
    ids = traffic.bucketize(payload, cfg, ipd_log2).long()
    el = F.embedding(ids[..., 0],
                     _quant_ste(params["embed_len/table"], _EMB_BITS, 1.0))
    ei = F.embedding(ids[..., 1],
                     _quant_ste(params["embed_ipd/table"], _EMB_BITS, 1.0))
    x = torch.cat([el, ei], dim=-1)                   # [B,T,2E]
    wz = _binarize_ste(params["gru/wz"])
    wr = _binarize_ste(params["gru/wr"])
    wh = _binarize_ste(params["gru/wh"])
    scale = float(1.0 / np.sqrt(x.shape[-1] + _UNITS))  # keep pre-acts sane
    h = torch.zeros((x.shape[0], _UNITS), dtype=x.dtype, device=x.device)
    for t in range(x.shape[1]):
        xt = x[:, t]
        xa = torch.cat([xt, h], dim=-1)
        z = sigmoid(xa @ wz * scale)
        r = sigmoid(xa @ wr * scale)
        xa2 = torch.cat([xt, r * h], dim=-1)
        hh = torch.tanh(xa2 @ wh * scale)
        h2 = (1 - z) * h + z * hh
        h = _quant_ste(h2, _HID_BITS, 1.0)            # 9-bit hidden states
    return h @ params["head/w"] + params["head/b"]


def loss_fn(params: Dict, cfg: TrafficModelConfig, batch: Dict,
            ipd_log2: IpdTable = None) -> Tuple[torch.Tensor, Dict]:
    return traffic.nll_and_acc(apply(params, cfg, batch["payload"],
                                     ipd_log2), batch)
