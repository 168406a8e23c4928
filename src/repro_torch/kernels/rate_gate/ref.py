"""Plain PyTorch versions of the Rate-Limiter gate (§4.2, Algorithm 1).

Port of ``repro/kernels/rate_gate/ref.py``.  ``fused_admission_ref`` is
the numerics contract of the fused admission kernel
(``kernel.fused_gate``): selection, the prefix-sum token-bucket credit
check and the bucket-level update in the reference's integer op order;
``rate_gate_ref`` is that of the selection-only kernel
(``kernel.rate_gate``).  The ``*_prng_ref`` pair are the plain versions
of the kernels that draw their own bits (``kernel.fused_gate_prng``,
``kernel.rate_gate_prng``): the same functions fed
``prng.randint(key, n, 0, 2^prob_bits)``, and ``threefry_draw_ref`` is
that of the chunk step's draws (``kernel.threefry_draw``).  All run on
any device; the CPU tests and ``chip_smoke.py``'s comparison use them.

The fused pair also takes a stack of pipes' batches, as the reference's
``vmap`` over pipes gives them: lanes [P, n], LUTs [P, TB, CB], bucket
registers [P] and keys [P, 2], each pipe on its own LUT, registers and
draws, the prefix sum along the last dimension.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import prng

I32 = torch.int32


def lut_prob(lut: torch.Tensor, t_i: torch.Tensor, c_i: torch.Tensor,
             t_shift: int, c_shift: int) -> torch.Tensor:
    """Shared binning + gather: the switch's shift/clip/SRAM read.  A
    stack of LUTs [P, TB, CB] serves lanes [P, n], pipe by pipe."""
    tb, cb = lut.shape[-2:]
    ti = torch.clamp(t_i >> t_shift, 0, tb - 1).long()
    ci = torch.clamp(c_i >> c_shift, 0, cb - 1).long()
    if lut.dim() == 2:
        return lut[ti, ci]
    pipe = torch.arange(lut.shape[0], device=lut.device)[:, None]
    return lut[pipe, ti, ci]


def rate_gate_ref(t_i, c_i, lut, rand16, t_shift: int, c_shift: int
                  ) -> torch.Tensor:
    """t_i/c_i/rand16 [N] int32; lut [TB,CB] int32 -> selected [N] bool."""
    return rand16 < lut_prob(lut, t_i, c_i, t_shift, c_shift)


def fused_admission_ref(t_i: torch.Tensor, c_i: torch.Tensor,
                        ts: torch.Tensor, lut: torch.Tensor,
                        rand16: torch.Tensor, burst0: torch.Tensor,
                        t_ref: torch.Tensor, t_shift: int, c_shift: int,
                        cost_us: int, bucket_cap_us: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(granted [N] bool, bucket_new 0-d int32); see the reference.
    Pipes' batches [P, N] (``burst0``, ``t_ref`` [P]) give ([P, N],
    [P])."""
    selected = rate_gate_ref(t_i, c_i, lut, rand16, t_shift, c_shift)
    credit = burst0[..., None] + torch.clamp_min(ts - t_ref[..., None], 0)
    spend = torch.cumsum(torch.where(selected, cost_us, 0).to(I32), -1,
                         dtype=I32)
    granted = selected & (spend <= credit)
    bucket_new = torch.clamp(
        credit[..., -1] - granted.sum(-1, dtype=I32) * cost_us, 0,
        bucket_cap_us).to(I32)
    return granted, bucket_new


def draw_rand16(key: torch.Tensor, n: int, prob_bits: int) -> torch.Tensor:
    """The gate's [n] int32 uniform draws in [0, 2^prob_bits) from a
    threefry key: ``jax.random.randint(key, (n,), 0, 2^prob_bits)``."""
    return prng.randint(key, n, 0, 1 << prob_bits)


def threefry_draw_ref(key: torch.Tensor, n: int, prob_bits: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunk step's threefry split and the gate's draws (plain
    version of ``kernel.threefry_draw``): keys [P, 2] -> (key' [P, 2],
    sub [P, 2], rand16 [P, n] int32), ``split(key)`` and ``randint(sub,
    (n,), 0, 2^prob_bits)`` pipe by pipe."""
    keys = prng.split(key)
    sub = keys[:, 1].contiguous()
    return keys[:, 0], sub, draw_rand16(sub, n, prob_bits)


def rate_gate_prng_ref(t_i, c_i, lut, key, t_shift: int, c_shift: int,
                       prob_bits: int) -> torch.Tensor:
    """``rate_gate_ref`` on the draws of ``key``: selected [N] bool."""
    return rate_gate_ref(t_i, c_i, lut,
                         draw_rand16(key, t_i.shape[0], prob_bits),
                         t_shift, c_shift)


def fused_admission_prng_ref(t_i: torch.Tensor, c_i: torch.Tensor,
                             ts: torch.Tensor, lut: torch.Tensor,
                             key: torch.Tensor, burst0: torch.Tensor,
                             t_ref: torch.Tensor, t_shift: int,
                             c_shift: int, cost_us: int, bucket_cap_us: int,
                             prob_bits: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_admission_ref`` on the draws of ``key``."""
    return fused_admission_ref(t_i, c_i, ts, lut,
                               draw_rand16(key, t_i.shape[-1], prob_bits),
                               burst0, t_ref, t_shift, c_shift, cost_us,
                               bucket_cap_us)
