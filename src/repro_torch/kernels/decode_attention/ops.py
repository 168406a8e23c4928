"""Entry point of GQA decode attention: backend dispatch.  Port of
``repro/kernels/decode_attention/ops.py``.

``backend``: ``"cuda"`` runs the hand-written kernel
(:data:`kernel.decode_attention`) and needs CUDA tensors; ``"ref"`` runs
the plain PyTorch version on any device; ``None`` picks ``"cuda"`` for
CUDA tensors and ``"ref"`` for CPU tensors.  The reference's wrapper
transposes K/V to ``[B,Hkv,S,D]`` and pads S to a multiple of its chunk;
the Hopper kernel reads the cache in place and masks the ragged tail
itself, so nothing is copied or padded here.
"""

from __future__ import annotations

import numbers
from typing import Optional

import torch

from repro_torch._device import resolve_backend
from repro_torch.kernels.decode_attention.kernel import decode_attention \
    as _kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, ck: int = 1024,
                     backend: Optional[str] = None) -> torch.Tensor:
    """q [B,Hq,D]; k,v [B,S,Hkv,D]; lengths [B] -> [B,Hq,D] in V's dtype.
    An empty row gives NaN with ``"ref"`` (as the reference's oracle)
    and 0 with ``"cuda"`` (as the TPU kernel).

    ``ck`` is the reference's K/V block length (its TPU kernel's grid
    step), taken in its position so that a call written for the
    reference binds the same; it must be a positive int.  The Hopper
    kernel sets its own split of S (``kernel.num_splits``, from the
    shapes and the SM count) and the plain version has none, so the
    result does not depend on ``ck``, bit for bit."""
    if isinstance(ck, bool) or not isinstance(ck, numbers.Integral) \
            or ck <= 0:
        raise ValueError(f"ck must be a positive int, got {ck!r}")
    if resolve_backend(backend, q, "attn_backend") == "ref":
        return decode_attention_ref(q, k, v, lengths)
    return _kernel(q, k, v, lengths.to(torch.int32))
