"""Buffer Manager (§4.3): per-flow feature ring buffers + mirror packets.

Port of ``repro/core/data_engine/buffer_manager.py``, one packet at a
time on 0-d tensors.  The buffer index increments and wraps by compare
(the data plane cannot do modulo).  On a Rate-Limiter grant the ring is
read out in temporal order, the current packet's feature (F9) is
appended, and the assembled header rides a mirrored packet to the Model
Engine.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.data_engine.state import EngineConfig, get_at, set_at

I32 = torch.int32


def extract_feature(state: Dict, cfg: EngineConfig, slot, pkt,
                    is_new) -> torch.Tensor:
    """Per-packet feature vector [2] int32: (packet length,
    inter-packet delay)."""
    ipd = torch.where(is_new, 0,
                      pkt["ts_us"] - get_at(state["last_ts"], slot))
    return torch.stack([pkt["pkt_len"].to(I32),
                        torch.clamp_min(ipd, 0).to(I32)])


def push(state: Dict, cfg: EngineConfig, slot, feat, ts) -> Dict:
    """Write the feature into the flow's ring; advance buff_idx without
    modulo."""
    s = dict(state)
    idx = get_at(state["buff_idx"], slot)
    s["ring"] = set_at(state["ring"], (slot, idx), feat)
    nxt = idx + 1
    nxt = torch.where(nxt == cfg.ring_depth, 0, nxt)   # wrap by compare
    s["buff_idx"] = set_at(state["buff_idx"], slot, nxt)
    s["last_ts"] = set_at(state["last_ts"], slot, ts)
    return s


def assemble(state: Dict, cfg: EngineConfig, slot, cur_feat
             ) -> torch.Tensor:
    """Mirror-packet payload [depth+1, 2]: the ring in temporal order
    (from buff_idx, the next write position = the oldest entry) and the
    current feature F9."""
    ring = get_at(state["ring"], slot)                    # [depth, feat]
    idx = get_at(state["buff_idx"], slot)
    order = torch.remainder(
        idx + torch.arange(cfg.ring_depth, device=idx.device), cfg.ring_depth)
    seq = ring[order]                                     # oldest..newest
    return torch.cat([seq, cur_feat[None]], dim=0)
