"""Rate Limiter (§4.2): probabilistic token bucket, Algorithm 1.

Port of ``step``, ``admit_batch``, ``control_plane_update`` and
``control_plane_update_pipes`` from
``repro/core/data_engine/rate_limiter.py``.  ``admit_batch`` and the
control plane also take a stacked [P, ...] state of the multi-pipe
driver: one fused admission call for every pipe's batch, and one LUT
rebuild a pipe from its own window counters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.data_engine import flow_tracker as ft
from repro_torch.core.data_engine.state import EngineConfig, get_at, set_at
from repro_torch.core.probability import build_lut_torch
from repro_torch.kernels.rate_gate.ops import fused_admission
from repro_torch.kernels.rate_gate.ref import lut_prob

I32 = torch.int32


def step(state: Dict, cfg: EngineConfig, slot: torch.Tensor,
         ts: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Algorithm 1 for one packet (0-d ``slot``, int32 ``ts``).  Returns
    (state', granted 0-d bool)."""
    s = dict(state)
    # lines 1-5: refill by elapsed gap
    first = state["t_last"] == 0
    gap = torch.where(first, 0, ts - state["t_last"])
    s["t_last"] = ts.to(I32)
    bucket = torch.clamp_max(state["bucket"] + gap, cfg.bucket_cap_us)
    # line 6: rand + LUT probability on (T_i, C_i).  The reference draws
    # randint(sub, ()), which is lane 0 of randint(sub, (n,))
    key, sub = prng.split(state["rng_key"])
    s["rng_key"] = key
    rand = prng.randint(sub, 1, 0, 1 << cfg.lut.prob_bits)[0]
    bklog_n, bklog_t = get_at(state["bklog_n"], slot), \
        get_at(state["bklog_t"], slot)
    t_i = torch.clamp_min(ts - bklog_t, 0)
    c_i = torch.clamp_min(bklog_n, 0)
    selected = rand < lut_prob(state["lut"], t_i.reshape(1),
                               c_i.reshape(1), cfg.lut.t_shift,
                               cfg.lut.c_shift)[0]
    # lines 8-12: consume if selected and enough tokens
    has_tokens = bucket >= cfg.cost_us
    granted = selected & has_tokens
    s["bucket"] = torch.where(granted, bucket - cfg.cost_us, bucket).to(I32)
    # telemetry + per-flow backlog reset on grant
    s["granted"] = state["granted"] + granted.to(I32)
    s["denied_prob"] = state["denied_prob"] + (~selected).to(I32)
    s["denied_tokens"] = state["denied_tokens"] \
        + (selected & ~has_tokens).to(I32)
    s["bklog_n"] = set_at(state["bklog_n"], slot,
                          torch.where(granted, 0, bklog_n))
    s["bklog_t"] = set_at(state["bklog_t"], slot,
                          torch.where(granted, ts, bklog_t))
    return s, granted


def admit_batch(state: Dict, cfg: EngineConfig, t_i: torch.Tensor,
                c_i: torch.Tensor, ts: torch.Tensor,
                rand16: Optional[torch.Tensor] = None,
                key: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized Algorithm 1 for one packet batch: ONE fused call
    against the state's LUT and bucket registers, on the draws
    ``rand16`` or, for ``gate_backend="cuda_prng"``, on those the kernel
    makes from the chunk's threefry subkey ``key``.  Returns (granted [n]
    bool, bucket_new 0-d int32); for a stacked state and lanes [P, n],
    (granted [P, n], bucket_new [P]) from one call."""
    return fused_admission(
        t_i, c_i, ts, state["lut"], state["bucket"], state["t_last"],
        rand16=rand16, key=key, cost_us=cfg.cost_us,
        bucket_cap_us=cfg.bucket_cap_us, t_shift=cfg.lut.t_shift,
        c_shift=cfg.lut.c_shift, prob_bits=cfg.lut.prob_bits,
        backend=cfg.gate_backend)


def control_plane_update(state: Dict, cfg: EngineConfig) -> Dict:
    """T_w rollover: rebuild the LUT from the window statistics (N, Q)
    and reset the window, anchored at the state's own ``t_last`` — on
    the state's device, with no host read."""
    s = dict(state)
    s["lut"] = build_lut_torch(state["flow_cnt"], state["win_pkt_cnt"],
                               window_us=cfg.window_us,
                               v=cfg.token_rate_per_us, cfg=cfg.lut)
    return ft.window_reset(s, cfg, state["t_last"])


def control_plane_update_pipes(state: Dict, local_cfg: EngineConfig,
                               num_pipes: int = 0) -> Dict:
    """The T_w rollover of every pipe of a stacked [P, ...] state: each
    pipe's LUT from its own window counters and its own rate share
    (``local_cfg``), each window anchored at the pipe's own clock — the
    reference's vmap of :func:`control_plane_update`, as one batched
    rebuild (element for element the same float32 ops).  ``num_pipes``
    is the reference's parameter, kept for its callers: the stacked
    leading dimension is authoritative."""
    return control_plane_update(state, local_cfg)
