"""Plain PyTorch version of the INT8 systolic GEMM (FENIX §5.2).

Port of ``repro/kernels/int8_matmul/ref.py``: C = A(int8) @ B(int8)
accumulated exactly, plus an optional int32 bias, optionally
requantized by a round-half-up ``>> shift`` and saturated to
[-127, 127] int8.  PyTorch has no integer matmul on CUDA, so the
product runs in float64, which is exact here: |acc| <= K * 127^2 stays
far below 2^53 for every K this model uses.  Bias and requantization
then run in int32, wrapping as the reference's int32 arithmetic does.
"""

from __future__ import annotations

from typing import Optional

import torch

I32 = torch.int32


def int8_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    shift: Optional[int] = None) -> torch.Tensor:
    """a [M,K] int8, b [K,N] int8, bias [N] int32 -> [M,N] int8 when
    ``shift`` is given, raw int32 otherwise."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError("int8_matmul_ref takes int8 operands")
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(I32)
    if bias is not None:
        acc = acc + bias.to(I32)[None, :]
    if shift is None:
        return acc
    rounded = (acc + (1 << (shift - 1))) >> shift if shift > 0 else acc
    return torch.clamp(rounded, -127, 127).to(torch.int8)
