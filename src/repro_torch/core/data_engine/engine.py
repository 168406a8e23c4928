"""The Data Engine's vectorized fast path (§4): one packet batch through
flow tracking, the fused admission gate and the feature rings.

Port of ``process_batch_fast`` from ``repro/core/data_engine/engine.py``,
with ``_first_occurrence`` and the sort/segment ``_running_count``.  The
exact per-packet scan ``process_batch`` is not ported yet (ROADMAP).

The reference writes the flow table with ``.at[slot].set`` where a batch
may hold several packets of one slot; XLA on the CPU lets the last write
win.  PyTorch on CUDA applies duplicate indices in no set order, so
every table write here first gathers, for each lane, the value of the
LAST lane of its slot (``_last_lane``): duplicates then all write the
same value and the result is the same on every device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.data_engine import rate_limiter as rl
from repro_torch.core.data_engine.state import EngineConfig, hash_five_tuple

I32 = torch.int32


def _first_occurrence(slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Mask of packets that are the first in batch to touch their slot."""
    n = slot.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=slot.device)
    first = torch.full((n_slots,), n, dtype=torch.int64, device=slot.device)
    first = first.scatter_reduce(0, slot, lane, reduce="amin")
    return first[slot] == lane


def _last_lane(slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For each packet, the lane of the last packet of its slot."""
    n = slot.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=slot.device)
    last = torch.full((n_slots,), -1, dtype=torch.int64, device=slot.device)
    last = last.scatter_reduce(0, slot, lane, reduce="amax")
    return last[slot]


def _running_count(slot: torch.Tensor) -> torch.Tensor:
    """#earlier packets in this batch with the same slot: stable-sort by
    slot, then each packet's rank within its equal-slot run."""
    n = slot.shape[0]
    order = torch.argsort(slot, stable=True)
    s = slot[order]
    idx = torch.arange(n, dtype=torch.int64, device=slot.device)
    is_start = torch.ones((n,), dtype=torch.bool, device=slot.device)
    is_start[1:] = s[1:] != s[:-1]
    seg_first = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    run = torch.empty((n,), dtype=I32, device=slot.device)
    run[order] = (idx - seg_first).to(I32)
    return run


def process_batch_fast(state: Dict, packets: Dict, cfg: EngineConfig
                       ) -> Tuple[Dict, Dict]:
    """Vectorized admission (the simulator's fast path).

    ``packets``: [n] tensors — src_ip, dst_ip, src_port, dst_port, proto
    (uint32 values in int64), ts_us, pkt_len (int32).  Returns (state',
    outputs) with outputs granted [n] bool, slot [n] int32, hash [n]
    int64, payload [n, ring_depth+1, feat_dim] int32, verdict [n] int32
    and is_new [n] bool, equal to the reference's leaf for leaf.
    """
    n = packets["ts_us"].shape[0]
    ts = packets["ts_us"].to(I32)
    h = hash_five_tuple(packets["src_ip"], packets["dst_ip"],
                        packets["src_port"], packets["dst_port"],
                        packets["proto"])
    slot = h & (cfg.n_slots - 1)                    # int64 index
    stored = state["hash"][slot]
    is_new = _first_occurrence(slot, cfg.n_slots) \
        & ((stored == 0) | (stored != h))
    run = _running_count(slot)
    t_i = torch.clamp_min(ts - state["bklog_t"][slot], 0)
    c_i = torch.clamp_min(state["bklog_n"][slot], 0) + run
    key, sub = prng.split(state["rng_key"])
    rand = prng.randint(sub, n, 0, 1 << cfg.lut.prob_bits)
    granted, bucket_new = rl.admit_batch(state, cfg, t_i, c_i, ts, rand)
    s = dict(state)
    s["rng_key"] = key
    s["bucket"] = bucket_new
    s["t_last"] = ts[-1]
    s["granted"] = state["granted"] + granted.sum(dtype=I32)
    # features + mirror payloads from the PRE-update ring (F1..F8 then
    # F9); ipd is 0 for flows new to the table
    known = (stored != 0) & (stored == h)
    ipd = torch.where(known, torch.clamp_min(ts - state["last_ts"][slot],
                                             0), 0).to(I32)
    feat = torch.stack([packets["pkt_len"].to(I32), ipd], dim=-1)
    idx = state["buff_idx"][slot].long()
    depth = cfg.ring_depth
    order = torch.remainder(
        idx[:, None] + torch.arange(depth, device=idx.device)[None], depth)
    seq = torch.take_along_dim(state["ring"][slot], order[..., None], dim=1)
    payload = torch.cat([seq, feat[:, None]], dim=1)
    # flow-table bulk update, last write per slot wins: every lane writes
    # the value of the last lane of its slot (see the module docstring)
    last = _last_lane(slot, cfg.n_slots)
    s["hash"] = state["hash"].index_put((slot,), h[last])
    s["ring"] = state["ring"].index_put((slot, idx), feat[last])
    nxt = torch.where(idx + 1 == depth, 0, idx + 1).to(I32)
    s["buff_idx"] = state["buff_idx"].index_put((slot,), nxt)
    s["last_ts"] = state["last_ts"].index_put((slot,), ts[last])
    added = state["bklog_n"].index_add(0, slot,
                                       torch.ones_like(ts))
    g_last = granted[last]
    s["bklog_n"] = added.index_put((slot,),
                                   torch.where(g_last, 0, added[slot]))
    s["bklog_t"] = state["bklog_t"].index_put(
        (slot,), torch.where(g_last, ts[last], state["bklog_t"][slot]))
    s["flow_cnt"] = state["flow_cnt"] + is_new.sum(dtype=I32)
    s["win_pkt_cnt"] = state["win_pkt_cnt"] + n
    cls = state["cls"][slot]
    out = {"granted": granted, "slot": slot.to(I32), "hash": h,
           "payload": payload, "verdict": torch.where(cls >= 0, cls, -1),
           "is_new": is_new}
    return s, out
