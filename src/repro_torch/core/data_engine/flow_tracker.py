"""Flow Tracker (§4.1): flow table lookup/update, windowed flow counting
and verdict write-back.

Port of ``repro/core/data_engine/flow_tracker.py``: ``lookup``,
``on_packet``, ``window_reset`` (``window_reset_pipes`` for a stacked
state) and ``apply_inference_result``.  The
per-packet pair works on 0-d tensors and writes the table out of place
(``state.set_at``), as the reference's ``.at[slot].set`` does.
Collision policy: a packet whose slot holds a different hash evicts the
resident flow (initializes the entry).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.data_engine.state import (EngineConfig, get_at,
                                                hash_five_tuple, set_at)

I32 = torch.int32


def lookup(state: Dict, cfg: EngineConfig, pkt: Dict) -> Tuple:
    """One packet's (slot, h, is_new, is_collision): 0-d tensors, slot
    int64, h int64 holding the uint32 hash."""
    h = hash_five_tuple(pkt["src_ip"], pkt["dst_ip"], pkt["src_port"],
                        pkt["dst_port"], pkt["proto"])
    slot = h & (cfg.n_slots - 1)
    stored = get_at(state["hash"], slot)
    empty = stored == 0
    collision = (~empty) & (stored != h)
    is_new = empty | collision
    return slot, h, is_new, collision


def on_packet(state: Dict, cfg: EngineConfig, slot, h, is_new, collision,
              ts) -> Dict:
    """Init-or-update the flow entry; maintain window flow counting."""
    s = dict(state)

    def update(k, if_new, else_):
        s[k] = set_at(state[k], slot, torch.where(is_new, if_new, else_))

    # (re)initialize on new flow / collision eviction
    s["hash"] = set_at(state["hash"], slot, h)
    update("bklog_n", 0, get_at(state["bklog_n"], slot) + 1)
    update("bklog_t", ts, get_at(state["bklog_t"], slot))
    update("cls", -1, get_at(state["cls"], slot))
    update("pkt_cnt", 1, get_at(state["pkt_cnt"], slot) + 1)
    update("buff_idx", 0, get_at(state["buff_idx"], slot))
    # window statistics: count flows whose first packet lands in this T_w
    s["flow_cnt"] = state["flow_cnt"] + is_new.to(I32)
    s["win_pkt_cnt"] = state["win_pkt_cnt"] + 1
    s["collisions"] = state["collisions"] + collision.to(I32)
    return s


def window_reset(state: Dict, cfg: EngineConfig, now: torch.Tensor
                 ) -> Dict:
    """Control-plane T_w rollover: the flow and packet counters restart
    and the new window anchors at ``now`` (a tensor on the state's
    device; no host read).  ``cfg`` is the reference's parameter and sets
    nothing here.  The counters keep their shape: on a stacked [P] state
    they stay [P] zeros, where the reference writes 0-d ones."""
    s = dict(state)
    s["flow_cnt"] = torch.zeros_like(state["flow_cnt"])
    s["win_pkt_cnt"] = torch.zeros_like(state["win_pkt_cnt"])
    s["win_start"] = now.to(I32)
    return s


def window_reset_pipes(state: Dict, cfg: EngineConfig) -> Dict:
    """T_w rollover of a stacked [P, ...] state: each pipe's counters
    restart and its window anchors at that pipe's own clock ``t_last``."""
    return window_reset(state, cfg, state["t_last"])


def apply_inference_result(state: Dict, slot: torch.Tensor,
                           cls: torch.Tensor, h: torch.Tensor) -> Dict:
    """A Model-Engine verdict returns to the switch (§5.1): write ``cls``
    if the slot still belongs to the same flow (0-d tensors)."""
    s = dict(state)
    still_owner = get_at(state["hash"], slot) == h
    s["cls"] = set_at(state["cls"], slot,
                      torch.where(still_owner, cls.to(I32),
                                  get_at(state["cls"], slot)))
    return s
