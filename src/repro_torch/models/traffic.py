"""Feature bucketization of the FENIX traffic classifiers (§6).

Port of ``bucketize`` from ``repro/models/traffic.py``.  The float model
and its training are not ported yet (ROADMAP, training slice).

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

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.fenix_models import TrafficModelConfig

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
