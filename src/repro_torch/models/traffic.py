"""FENIX traffic classifiers (paper §6, §7.1 schemes a/b/d/e).

Port of ``repro/models/traffic.py``: the feature bucketization and the
float models that train (the quantized INT8 path is
``quant/quantize.py``).

FENIX-CNN: embeddings -> 3 conv1d layers (64,128,256 filters, k=3, relu)
           -> global average pool -> FC 512 -> FC 256 -> classes.
FENIX-RNN: embeddings -> custom RNN cell (128 units, tanh) -> dense output.

``init`` makes the reference Registrar's numpy draws and casts them to
float32, so its params are bit for bit the reference's.  The forward is
plain PyTorch, op for op the reference's: ``_conv1d`` is im2col and an
einsum (as the int8 path), the RNN a Python loop over the window's
steps (the reference's ``lax.scan``).

The reference's ipd bucket is ``2 * floor(log2(1 + float32(ipd)))``,
and ``jnp.log2`` is ``log(x) / log(2)`` in float32 through XLA's own
``log``.  That quotient lands on the wrong side of an integer for 63
inputs within 1e-6 of a power of two (8192 gives 12, 2097151 gives 21).
PyTorch's ``log2`` differs from it there, and so does every other
``log`` a device may carry, so the port computes the exact exponent from
the float32 bits and carries those 63 inputs as a table
(``_LOG2_EXCEPTIONS``).  tests/test_torch_int8_matmul.py re-derives the
table from JAX and sweeps every ipd up to 2^20 and around every power of
two up to 2^31.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.fenix_models import TrafficModelConfig
from repro_torch.models.param import Registrar

F32 = torch.float32

# (first, last, step, value): float32 values f = 1 + float32(ipd) for
# which the reference's floor(log2(f)) is `value`, not the exponent of f
_LOG2_EXCEPTIONS = (
    (8192, 8192, 1, 12),
    (32768, 32768, 1, 14),
    (2097151, 2097151, 1, 21),
    (4194303, 4194303, 1, 22),
    (8388601, 8388607, 1, 23),
    (16777201, 16777215, 1, 24),
    (33554418, 33554430, 2, 25),
    (67108864, 67108864, 1, 25),
    (134217728, 134217792, 16, 26),
    (268435216, 268435440, 16, 28),
    (536870688, 536870880, 32, 29),
    (1073741824, 1073741824, 1, 29),
    (2147483648, 2147483648, 1, 30),
)


def ipd_log2_table(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted float32 bit patterns [63] int32, floor-log2 values [63]
    int32) of the reference's exceptional inputs, on ``device``."""
    f = np.concatenate([np.arange(a, b + 1, s, dtype=np.float64)
                        for a, b, s, _ in _LOG2_EXCEPTIONS])
    v = np.concatenate([np.full(len(range(a, b + 1, s)), lg)
                        for a, b, s, lg in _LOG2_EXCEPTIONS])
    keys = f.astype(np.float32).view(np.int32)
    order = np.argsort(keys)
    return (torch.as_tensor(keys[order]).to(device),
            torch.as_tensor(v[order].astype(np.int32)).to(device))


def bucketize(payload: torch.Tensor, cfg: TrafficModelConfig,
              ipd_log2: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """payload [..., T, 2] int32 (len, ipd_us) -> ids [..., T, 2] int32.

    len buckets: len >> 5; ipd buckets: 2 * floor(log2(1 + ipd)); both
    clip to the table size.  ``ipd_log2`` is :func:`ipd_log2_table` on
    the payload's device (built here when not given; callers in a replay
    loop pass it in, so no table is copied to the card per call).
    """
    ln = torch.clamp(payload[..., 0] >> 5, 0, cfg.len_buckets - 1)
    ipd = torch.clamp_min(payload[..., 1], 0)
    f = ipd.to(torch.float32) + 1.0
    bits = f.view(torch.int32)
    lg = (bits >> 23) - 127                  # exact floor(log2(f)), f >= 1
    keys, vals = (ipd_log2 if ipd_log2 is not None
                  else ipd_log2_table(payload.device))
    pos = torch.clamp_max(torch.searchsorted(keys, bits), keys.shape[0] - 1)
    lg = torch.where(keys[pos] == bits, vals[pos], lg)
    ip = torch.clamp(2 * lg, 0, cfg.ipd_buckets - 1)
    return torch.stack([ln, ip], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(reg: Registrar, cfg: TrafficModelConfig) -> None:
    e = cfg.embed_dim
    reg.param("embed_len/table", (cfg.len_buckets, e), ("vocab", "embed"),
              scale=0.5, dtype=F32)
    reg.param("embed_ipd/table", (cfg.ipd_buckets, e), ("vocab", "embed"),
              scale=0.5, dtype=F32)
    d_in = 2 * e
    if cfg.kind == "cnn":
        c_prev = d_in
        for i, ch in enumerate(cfg.conv_filters):
            reg.param(f"conv{i}/w", (cfg.conv_kernel, c_prev, ch),
                      ("conv", "embed", "ffn"), scale=(cfg.conv_kernel
                                                       * c_prev) ** -0.5,
                      dtype=F32)
            reg.param(f"conv{i}/b", (ch,), ("ffn",), init="zeros", dtype=F32)
            c_prev = ch
        f_prev = c_prev
        for i, fc in enumerate(cfg.fc_dims):
            reg.param(f"fc{i}/w", (f_prev, fc), ("embed", "ffn"),
                      scale=f_prev ** -0.5, dtype=F32)
            reg.param(f"fc{i}/b", (fc,), ("ffn",), init="zeros", dtype=F32)
            f_prev = fc
        reg.param("head/w", (f_prev, cfg.num_classes), ("embed", "classes"),
                  scale=f_prev ** -0.5, dtype=F32)
        reg.param("head/b", (cfg.num_classes,), ("classes",), init="zeros",
                  dtype=F32)
    else:  # rnn
        u = cfg.rnn_units
        reg.param("cell/wx", (d_in, u), ("embed", "ffn"), scale=d_in ** -0.5,
                  dtype=F32)
        reg.param("cell/wh", (u, u), ("ffn", "ffn"), scale=u ** -0.5,
                  dtype=F32)
        reg.param("cell/b", (u,), ("ffn",), init="zeros", dtype=F32)
        reg.param("head/w", (u, cfg.num_classes), ("embed", "classes"),
                  scale=u ** -0.5, dtype=F32)
        reg.param("head/b", (cfg.num_classes,), ("classes",), init="zeros",
                  dtype=F32)


def init(cfg: TrafficModelConfig, seed: int = 0,
         device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The float params on ``device`` (``cuda`` unless the caller names
    another)."""
    reg = Registrar(abstract=False, seed=seed, dtype=F32,
                    device=resolve_device(device))
    init_params(reg, cfg)
    return reg.params


# ---------------------------------------------------------------------------
# Float forward (training / fp oracle)
# ---------------------------------------------------------------------------


def embed_ids(params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """ids [..., T, 2] -> [..., T, 2E] float."""
    ids = ids.long()
    el = F.embedding(ids[..., 0], params["embed_len/table"])
    ei = F.embedding(ids[..., 1], params["embed_ipd/table"])
    return torch.cat([el, ei], dim=-1)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """'same' conv1d via im2col (mirrors the int8 path exactly)."""
    k = w.shape[0]
    pad = k // 2
    s = x.shape[1]
    xp = F.pad(x, (0, 0, pad, k - 1 - pad))
    cols = torch.stack([xp[:, i:i + s] for i in range(k)], dim=2)
    return torch.einsum("bskc,kcf->bsf", cols, w) + b


def apply(params: Dict, cfg: TrafficModelConfig, payload: torch.Tensor,
          ipd_log2: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
          ) -> torch.Tensor:
    """payload [B,T,2] int32 -> logits [B,classes] (float path).
    ``ipd_log2`` as in :func:`bucketize` (a captured train step must be
    given it: building it copies from the host)."""
    ids = bucketize(payload, cfg, ipd_log2)
    x = embed_ids(params, ids)                        # [B,T,2E]
    if cfg.kind == "cnn":
        for i in range(len(cfg.conv_filters)):
            x = torch.relu(_conv1d(x, params[f"conv{i}/w"],
                                   params[f"conv{i}/b"]))
        x = torch.mean(x, dim=1)                      # global average pool
        for i in range(len(cfg.fc_dims)):
            x = torch.relu(x @ params[f"fc{i}/w"] + params[f"fc{i}/b"])
        return x @ params["head/w"] + params["head/b"]
    # rnn: the reference's lax.scan over the steps
    h = torch.zeros((x.shape[0], cfg.rnn_units), dtype=x.dtype,
                    device=x.device)
    for t in range(x.shape[1]):
        h = torch.tanh(x[:, t] @ params["cell/wx"] + h @ params["cell/wh"]
                       + params["cell/b"])
    return h @ params["head/w"] + params["head/b"]


def loss_fn(params: Dict, cfg: TrafficModelConfig, batch: Dict,
            ipd_log2: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Weighted NLL (mean over the batch) and accuracy."""
    return nll_and_acc(apply(params, cfg, batch["payload"], ipd_log2), batch)


def nll_and_acc(logits: torch.Tensor, batch: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """The weighted NLL of ``logits`` against ``batch["label"]`` (mean
    over the batch; ``batch["weight"]`` when given) and the accuracy."""
    labels = batch["label"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
    w = batch.get("weight")
    loss = torch.mean(nll * w) if w is not None else torch.mean(nll)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(F32))
    return loss, {"acc": acc}
