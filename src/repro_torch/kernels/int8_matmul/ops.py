"""Entry points of the INT8 systolic GEMM: backend dispatch and
conv-as-GEMM.  Port of ``repro/kernels/int8_matmul/ops.py``.

``backend``: ``"cuda"`` runs the hand-written kernel
(:data:`kernel.int8_gemm`) and needs CUDA tensors; ``"ref"`` runs the
plain PyTorch version on any device; ``None`` picks ``"cuda"`` for CUDA
tensors and ``"ref"`` for CPU tensors.  The reference pads M/N/K to the
TPU's 128-multiple blocks; the Hopper kernel masks ragged edges itself,
so nothing is padded here.  The kernel takes B K-major (``k_major``);
the plain version takes either layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_backend
from repro_torch.kernels.int8_matmul.kernel import int8_gemm
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref


def k_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` [..., N] as a view of the same shape and values over a
    buffer whose reduction dimensions are contiguous (a [N, ...] buffer
    with N moved last): the layout of the kernel's B.  For a conv weight
    [kk, Cin, Cout] this keeps ``w.reshape(kk * Cin, Cout)`` a view."""
    return w.movedim(-1, 0).contiguous().movedim(0, -1)


def int8_matmul(a: torch.Tensor, b: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                shift: Optional[int] = None,
                backend: Optional[str] = None) -> torch.Tensor:
    """INT8 GEMM with int32 accumulation and pow2 requantization.

    a [M,K] int8, b [K,N] int8 (K-major for ``"cuda"``: see
    :func:`k_major`), bias [N] int32 (optional); ``shift`` rounds half up
    and saturates to int8, ``None`` returns the raw int32 accumulator.
    Bit-identical across backends and with the reference.
    """
    if resolve_backend(backend, a, "matmul_backend") == "ref":
        return int8_matmul_ref(a, b, bias=bias, shift=shift)
    return int8_gemm(a, b, bias=bias, shift=shift)


def int8_conv1d(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor], shift: Optional[int],
                backend: Optional[str] = None) -> torch.Tensor:
    """'same'-padded conv1d as im2col onto :func:`int8_matmul`.

    x [B,S,Cin] int8, w [K,Cin,Cout] int8 (K odd; for ``"cuda"`` a
    :func:`k_major` view, whose reshape to [K*Cin, Cout] is a view, not
    a copy) -> [B,S,Cout] (int8 when ``shift`` is given, int32
    otherwise).
    """
    bsz, s, cin = x.shape
    kk, _, cout = w.shape
    pad = kk // 2
    xp = F.pad(x, (0, 0, pad, kk - 1 - pad))
    cols = torch.stack([xp[:, i:i + s] for i in range(kk)], dim=2)
    a = cols.reshape(bsz * s, kk * cin)
    y = int8_matmul(a, w.reshape(kk * cin, cout), bias=bias, shift=shift,
                    backend=backend)
    return y.reshape(bsz, s, cout)
