"""Entry points of the Rate-Limiter gate: backend dispatch, the random
draws and the bucket-register derivation.  Port of
``repro/kernels/rate_gate/ops.py`` (``rate_gate``, ``fused_admission``).

``backend`` (:data:`GATE_BACKENDS`): ``"cuda"`` runs the hand-written
kernel on caller-supplied draws; ``"cuda_prng"`` runs the kernel that
draws its own bits on the card from a threefry key (the counterpart of
the reference's on-core-PRNG ``"pallas_tpu"``); both need CUDA tensors.
``"ref"`` runs the plain PyTorch version on any device; ``None`` picks
``"cuda"`` for CUDA tensors and ``"ref"`` for CPU tensors.  Every draw is
the threefry stream of ``core.prng``, so all three backends give the
reference's verdicts bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import _device
from repro_torch.core import prng
from repro_torch.kernels.rate_gate import kernel as k
from repro_torch.kernels.rate_gate.ref import (draw_rand16,
                                               fused_admission_ref,
                                               rate_gate_ref,
                                               threefry_draw_ref)

I32 = torch.int32
GATE_BACKENDS = _device.BACKENDS["gate_backend"]


def validate_backend(name: Optional[str]) -> Optional[str]:
    """Check a gate backend name; returns it (raises ValueError else)."""
    return _device.validate_backend(name, "gate_backend")


def rate_gate(t_i: torch.Tensor, c_i: torch.Tensor, lut: torch.Tensor, *,
              rand16: Optional[torch.Tensor] = None,
              seed: Optional[int] = None, t_shift: int = 10,
              c_shift: int = 0, prob_bits: int = 16,
              backend: Optional[str] = None) -> torch.Tensor:
    """Selection-only probability gate: P-LUT lookup + random threshold.

      t_i, c_i  [n] int32   per-packet LUT coordinates, bucketed by
                            ``>> t_shift`` / ``>> c_shift`` and clipped
                            to the LUT's edges
      lut       [T, C] i32  admission probabilities as fixed-point
                            fractions of 2^prob_bits
      rand16    [n] int32   uniform draws in [0, 2^prob_bits); when None
                            they are ``randint(PRNGKey(seed or 0), (n,),
                            0, 2^prob_bits)``, as the reference draws them
                            — on the card by the kernel itself under
                            ``"cuda_prng"``, which takes no ``rand16``

    Returns [n] bool: ``rand16 < lut[t_i >> t_shift, c_i >> c_shift]``.
    The kernels mask ragged lanes, so nothing is padded.  Kept unfused
    for kernel sweeps; the Data Engine serves through
    :func:`fused_admission`.
    """
    backend = _device.resolve_backend(backend, t_i, "gate_backend")
    kw = dict(t_shift=t_shift, c_shift=c_shift)
    if rand16 is None:
        key = prng.PRNGKey(int(seed) if seed is not None else 0,
                           device=t_i.device)
        if backend == "cuda_prng":
            return k.rate_gate_prng(t_i, c_i, key, lut, prob_bits=prob_bits,
                                    **kw)
        rand16 = draw_rand16(key, t_i.shape[0], prob_bits)
    elif backend == "cuda_prng":
        raise ValueError("gate_backend=\"cuda_prng\" draws its own bits "
                         "from seed=; pass no rand16")
    if backend == "ref":
        return rate_gate_ref(t_i, c_i, lut, rand16, t_shift, c_shift)
    return k.rate_gate(t_i, c_i, rand16, lut, **kw)


def fused_admission(t_i: torch.Tensor, c_i: torch.Tensor, ts: torch.Tensor,
                    lut: torch.Tensor, bucket: torch.Tensor,
                    t_last: torch.Tensor, *,
                    rand16: Optional[torch.Tensor] = None,
                    key: Optional[torch.Tensor] = None, cost_us: int,
                    bucket_cap_us: int, t_shift: int = 10, c_shift: int = 0,
                    prob_bits: int = 16, backend: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused admission call per chunk: (granted [n] bool, bucket'
    0-d int32); for a stack of pipes' chunks (lanes [P, n], ``lut`` [P,
    TB, CB], ``bucket``/``t_last`` [P], ``key`` [P, 2]) one call for all
    of them: (granted [P, n], bucket' [P]).

    The draws are ``rand16`` or, when it is None, those of the threefry
    ``key`` (``randint(key, (n,), 0, 2^prob_bits)``); ``"cuda_prng"``
    takes ``key`` only and draws in the kernel.  ``bucket``/``t_last``
    are the batch-start token-bucket registers (0-d int32); the refill
    anchor and the burst cap are derived from them as the reference's
    ``ops.py:125-126`` does: here for ``"ref"``, inside the kernel for
    ``"cuda"``/``"cuda_prng"``, which then launch that one kernel and
    nothing else.  The kernels mask ragged lanes and read the true last
    timestamp, so nothing is padded.
    """
    backend = _device.resolve_backend(backend, t_i, "gate_backend")
    if (rand16 is None) == (key is None):
        raise ValueError("fused_admission takes one of rand16= and key=")
    if backend == "cuda_prng" and key is None:
        raise ValueError("gate_backend=\"cuda_prng\" draws its own bits: "
                         "pass key=, not rand16=")
    kw = dict(t_shift=t_shift, c_shift=c_shift, cost_us=cost_us,
              bucket_cap_us=bucket_cap_us)
    if backend == "cuda_prng":
        return k.fused_gate_prng(t_i, c_i, ts, key, lut, bucket, t_last,
                                 prob_bits=prob_bits, **kw)
    if rand16 is None:
        rand16 = draw_rand16(key, t_i.shape[-1], prob_bits)
    if backend == "ref":
        t_ref = torch.where(t_last == 0, ts[..., 0], t_last).to(I32)
        burst0 = torch.clamp_max(bucket, bucket_cap_us).to(I32)
        return fused_admission_ref(t_i, c_i, ts, lut, rand16, burst0,
                                   t_ref, t_shift, c_shift, cost_us,
                                   bucket_cap_us)
    return k.fused_gate(t_i, c_i, ts, rand16, lut, bucket, t_last, **kw)


def threefry_draw(key: torch.Tensor, n: int, prob_bits: int = 16,
                  backend: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunk step's threefry split and the gate's draws: keys [P, 2]
    -> (key' [P, 2], sub [P, 2], rand16 [P, n] int32), ``split(key)``
    and ``randint(sub, (n,), 0, 2^prob_bits)`` pipe by pipe.  Both card
    backends run the one-launch kernel (n = 0 gives the split alone, all
    ``"cuda_prng"`` needs); ``"ref"`` runs the plain ``prng`` chain."""
    backend = _device.resolve_backend(backend, key, "gate_backend")
    if backend == "ref":
        return threefry_draw_ref(key, n, prob_bits)
    return k.threefry_draw(key, n, prob_bits)
