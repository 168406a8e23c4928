"""Flow Tracker (§4.1): windowed flow counting and verdict write-back.

Port of the parts of ``repro/core/data_engine/flow_tracker.py`` that the
device driver uses: ``window_reset`` and ``apply_inference_result``.
The per-packet ``lookup``/``on_packet`` pair belongs to the exact host
scan and is not ported yet (ROADMAP, next slices).
"""

from __future__ import annotations

from typing import Dict

import torch

I32 = torch.int32


def window_reset(state: Dict, now: torch.Tensor) -> Dict:
    """Control-plane T_w rollover: the flow and packet counters restart
    and the new window anchors at ``now``."""
    s = dict(state)
    s["flow_cnt"] = torch.zeros_like(state["flow_cnt"])
    s["win_pkt_cnt"] = torch.zeros_like(state["win_pkt_cnt"])
    s["win_start"] = now.to(I32)
    return s


def apply_inference_result(state: Dict, slot: torch.Tensor,
                           cls: torch.Tensor, h: torch.Tensor) -> Dict:
    """A Model-Engine verdict returns to the switch (§5.1): write ``cls``
    if the slot still belongs to the same flow (0-d tensors)."""
    s = dict(state)
    still_owner = state["hash"][slot] == h
    cls_new = state["cls"].clone()
    cls_new[slot] = torch.where(still_owner, cls.to(I32),
                                state["cls"][slot])
    s["cls"] = cls_new
    return s
