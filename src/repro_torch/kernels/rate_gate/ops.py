"""Entry point of the fused admission gate: backend dispatch and the
bucket-register derivation.  Port of ``repro/kernels/rate_gate/ops.py``
(``fused_admission``).

``backend``: ``"cuda"`` runs the hand-written kernel
(:data:`kernel.fused_gate`) and needs CUDA tensors; ``"ref"`` runs the
plain PyTorch version on any device; ``None`` picks ``"cuda"`` for CUDA
tensors and ``"ref"`` for CPU tensors.  Random bits always come from the
caller (the threefry draws of ``core.prng``), so verdicts are bit-exact
with the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._device import resolve_backend
from repro_torch.kernels.rate_gate.kernel import fused_gate
from repro_torch.kernels.rate_gate.ref import fused_admission_ref

I32 = torch.int32


def fused_admission(t_i: torch.Tensor, c_i: torch.Tensor, ts: torch.Tensor,
                    lut: torch.Tensor, bucket: torch.Tensor,
                    t_last: torch.Tensor, *, rand16: torch.Tensor,
                    cost_us: int, bucket_cap_us: int, t_shift: int = 10,
                    c_shift: int = 0, backend: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused admission call per chunk: (granted [n] bool, bucket'
    0-d int32).

    ``bucket``/``t_last`` are the batch-start token-bucket registers (0-d
    int32); the refill anchor and the burst cap are derived here as the
    reference's ``ops.py:125-126`` does.  The kernel masks ragged lanes
    itself and reads the true last timestamp, so nothing is padded.
    """
    backend = resolve_backend(backend, t_i, "gate_backend")
    t_ref = torch.where(t_last == 0, ts[0], t_last).to(I32)
    burst0 = torch.clamp_max(bucket, bucket_cap_us).to(I32)
    if backend == "ref":
        return fused_admission_ref(t_i, c_i, ts, lut, rand16, burst0,
                                   t_ref, t_shift, c_shift, cost_us,
                                   bucket_cap_us)
    scal = torch.stack([burst0, t_ref])
    return fused_gate(t_i, c_i, ts, rand16, lut, scal, t_shift=t_shift,
                      c_shift=c_shift, cost_us=cost_us,
                      bucket_cap_us=bucket_cap_us)
