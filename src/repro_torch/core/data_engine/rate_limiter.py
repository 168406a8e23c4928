"""Rate Limiter (§4.2): probabilistic token bucket, batch form.

Port of ``admit_batch`` and ``control_plane_update`` from
``repro/core/data_engine/rate_limiter.py``.  The per-packet ``step`` of
the exact host scan is not ported yet (ROADMAP, next slices).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.data_engine import flow_tracker as ft
from repro_torch.core.data_engine.state import EngineConfig
from repro_torch.core.probability import build_lut_torch
from repro_torch.kernels.rate_gate.ops import fused_admission


def admit_batch(state: Dict, cfg: EngineConfig, t_i: torch.Tensor,
                c_i: torch.Tensor, ts: torch.Tensor, rand16: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized Algorithm 1 for one packet batch: ONE fused call
    against the state's LUT and bucket registers.  Returns (granted [n]
    bool, bucket_new 0-d int32)."""
    return fused_admission(
        t_i, c_i, ts, state["lut"], state["bucket"], state["t_last"],
        rand16=rand16, cost_us=cfg.cost_us,
        bucket_cap_us=cfg.bucket_cap_us, t_shift=cfg.lut.t_shift,
        c_shift=cfg.lut.c_shift, backend=cfg.gate_backend)


def control_plane_update(state: Dict, cfg: EngineConfig) -> Dict:
    """T_w rollover: rebuild the LUT from the window statistics (N, Q)
    and reset the window, anchored at the state's own ``t_last`` — on
    the state's device, with no host read."""
    s = dict(state)
    s["lut"] = build_lut_torch(state["flow_cnt"], state["win_pkt_cnt"],
                               window_us=cfg.window_us,
                               v=cfg.token_rate_per_us, cfg=cfg.lut)
    return ft.window_reset(s, state["t_last"])
