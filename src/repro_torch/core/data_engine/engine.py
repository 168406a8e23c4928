"""The fused Data Engine (§4): one packet batch through flow tracking,
the Rate Limiter and the feature rings.

Port of ``repro/core/data_engine/engine.py``: ``process_batch`` is the
exact per-packet scan (the reference's ``lax.scan`` over ``_packet_step``
becomes a Python loop over the batch, several hundred small tensor ops
a packet, most of them the rate limiter's threefry draws), and
``process_batch_fast`` the vectorized fast path with
``_first_occurrence`` and the sort/segment ``_running_count``.
``process_pipes_fast`` runs the fast path of P pipes in one pass over
their [P * n] lanes (the reference vmaps ``process_batch_fast`` over a
stacked state); one pipe's is ``process_batch_fast``.

The reference writes the flow table with ``.at[slot].set`` where a batch
may hold several packets of one slot; XLA on the CPU lets the last write
win.  PyTorch on CUDA applies duplicate indices in no set order, so
every table write here first gathers, for each lane, the value of the
LAST lane of its slot (``_last_lane``): duplicates then all write the
same value and the result is the same on every device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import _telemetry as tm
from repro_torch._device import resolve_backend
from repro_torch.core.data_engine import buffer_manager as bm
from repro_torch.core.data_engine import flow_tracker as ft
from repro_torch.core.data_engine import rate_limiter as rl
from repro_torch.core.data_engine.decision_tree import predict
from repro_torch.core.data_engine.state import (EngineConfig, get_at,
                                                hash_five_tuple)
from repro_torch.kernels.rate_gate import ops as gate_ops

I32 = torch.int32


def _packet_step(state: Dict, pkt: Dict, cfg: EngineConfig,
                 tree: Optional[Dict] = None, tree_depth: int = 4
                 ) -> Tuple[Dict, Dict]:
    """One packet (0-d tensors) through Flow Tracker -> Rate Limiter ->
    Buffer Manager."""
    ts = pkt["ts_us"].to(I32)
    slot, h, is_new, collision = ft.lookup(state, cfg, pkt)
    state = ft.on_packet(state, cfg, slot, h, is_new, collision, ts)
    feat = bm.extract_feature(state, cfg, slot, pkt, is_new)
    # rate limiter decides whether this flow ships features now
    state, granted = rl.step(state, cfg, slot, ts)
    # mirror packet payload (F1..F8 + current F9), valid when granted
    payload = bm.assemble(state, cfg, slot, feat)
    state = bm.push(state, cfg, slot, feat, ts)
    # preliminary per-packet verdict (§4.1): stored class else switch tree
    stored_cls = get_at(state["cls"], slot)
    pre = (predict(tree, feat[None], tree_depth)[0] if tree is not None
           else -1)
    verdict = torch.where(stored_cls >= 0, stored_cls, pre)
    out = {"granted": granted, "slot": slot.to(I32), "hash": h,
           "payload": payload, "verdict": verdict, "is_new": is_new}
    return state, out


def process_batch(state: Dict, packets: Dict, cfg: EngineConfig,
                  tree: Optional[Dict] = None, tree_depth: int = 4
                  ) -> Tuple[Dict, Dict]:
    """Scan a packet batch through the pipeline one packet at a time
    (exact semantics: the shared token bucket and the rings see every
    packet in order).

    ``packets``: [n] tensors as for :func:`process_batch_fast`.  Returns
    (state', outputs stacked to [n, ...]), equal to the reference's leaf
    for leaf.
    """
    outs = []
    for i in range(packets["ts_us"].shape[0]):
        state, out = _packet_step(state, {k: v[i] for k, v in
                                          packets.items()},
                                  cfg, tree=tree, tree_depth=tree_depth)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


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


def _running_count_dense(slot: torch.Tensor) -> torch.Tensor:
    """O(n^2) reference for :func:`_running_count`: each packet's count
    of earlier packets with its slot, from the [n, n] equality matrix
    below the diagonal."""
    n = slot.shape[0]
    eq = slot[None, :] == slot[:, None]
    tri = torch.ones((n, n), dtype=torch.bool, device=slot.device).tril(-1)
    return (eq & tri).sum(dim=1).to(I32)


def process_batch_fast(state: Dict, packets: Dict, cfg: EngineConfig
                       ) -> Tuple[Dict, Dict]:
    """Vectorized admission (the simulator's fast path).

    ``packets``: [n] tensors — src_ip, dst_ip, src_port, dst_port, proto
    (uint32 values in int64), ts_us, pkt_len (int32).  Returns (state',
    outputs) with outputs granted [n] bool, slot [n] int32, hash [n]
    int64, payload [n, ring_depth+1, feat_dim] int32, verdict [n] int32
    and is_new [n] bool, equal to the reference's leaf for leaf.  It is
    :func:`process_pipes_fast` of one pipe.
    """
    states, outs = process_pipes_fast(
        {k: v[None] for k, v in state.items()},
        {k: v[None] for k, v in packets.items()}, cfg)
    return ({k: v[0] for k, v in states.items()},
            {k: v[0] for k, v in outs.items()})


def process_pipes_fast(states: Dict, packets: Dict, local_cfg: EngineConfig
                       ) -> Tuple[Dict, Dict]:
    """The fast path of P pipes in one pass: ``states`` is a stacked [P,
    ...] state (``state.init_pipes_state``), ``packets`` [P, n] tensors,
    pipe p's batch on pipe p's table, bucket and key with the local
    config, as the reference's vmap of ``process_batch_fast`` runs them.

    The [P * n] lanes run as one batch over the flattened global table:
    lane (p, i) addresses global slot ``p * n_slots + slot`` (its pipe's
    own table, whatever its hash), so no slot is shared across pipes and
    the first/last-lane and running-count passes see each pipe's lanes in
    the pipe's own order.  Returns (states', outputs [P, n, ...]).

    Under telemetry (``_telemetry``) its stages end at the marks
    ``flow`` (the hash, slots, first occurrences, running counts and
    backlog gathers), ``draw`` (the threefry split and draws, on the card
    the one ``threefry_draw`` launch; the split alone under
    ``cuda_prng``), ``gate`` and ``table`` (features, the ring gather and
    the flow-table writes)."""
    cfg = local_cfg
    pipes, n = packets["ts_us"].shape
    ls = cfg.n_slots
    ts = packets["ts_us"].to(I32)
    h = hash_five_tuple(packets["src_ip"], packets["dst_ip"],
                        packets["src_port"], packets["dst_port"],
                        packets["proto"])
    slot = h & (ls - 1)                             # int64, the pipe's own
    gslot = slot.reshape(-1)
    if pipes > 1:
        gslot = (slot + ls * torch.arange(pipes, device=slot.device)[:, None]
                 ).reshape(-1)

    def table(k):                                   # [P * n_slots, ...]
        return states[k].reshape((pipes * ls,) + states[k].shape[2:])

    def lanes(x):                                   # [P * n, ...] -> [P, n]
        return x.reshape((pipes, n) + x.shape[1:])

    stored = lanes(table("hash")[gslot])
    is_new = lanes(_first_occurrence(gslot, pipes * ls)) \
        & ((stored == 0) | (stored != h))
    run = lanes(_running_count_dense(gslot) if cfg.dense_backlog
                else _running_count(gslot))
    t_i = torch.clamp_min(ts - lanes(table("bklog_t")[gslot]), 0)
    c_i = torch.clamp_min(lanes(table("bklog_n")[gslot]), 0) + run
    tm.mark("flow", ts)
    # the cuda_prng gate draws randint(sub, (n,), ...) itself: there the
    # kernel gives the split alone
    backend = resolve_backend(cfg.gate_backend, ts, "gate_backend")
    key, sub, rand = gate_ops.threefry_draw(
        states["rng_key"], 0 if backend == "cuda_prng" else n,
        cfg.lut.prob_bits, backend=backend)
    tm.mark("draw", ts)
    granted, bucket_new = rl.admit_batch(
        states, cfg, t_i, c_i, ts,
        **(dict(key=sub) if backend == "cuda_prng" else dict(rand16=rand)))
    tm.mark("gate", ts)
    s = dict(states)
    s["rng_key"] = key
    s["bucket"] = bucket_new
    s["t_last"] = ts[:, -1].contiguous()      # a register the gate reads
    s["granted"] = states["granted"] + granted.sum(-1, dtype=I32)
    # features + mirror payloads from the PRE-update ring (F1..F8 then
    # F9); ipd is 0 for flows new to the table
    known = (stored != 0) & (stored == h)
    ipd = torch.where(known, torch.clamp_min(
        ts - lanes(table("last_ts")[gslot]), 0), 0).to(I32)
    feat = torch.stack([packets["pkt_len"].to(I32), ipd], dim=-1)
    feat = feat.reshape(pipes * n, -1)
    idx = table("buff_idx")[gslot].long()
    depth = cfg.ring_depth
    order = torch.remainder(
        idx[:, None] + torch.arange(depth, device=idx.device)[None], depth)
    seq = torch.take_along_dim(table("ring")[gslot], order[..., None],
                               dim=1)
    payload = torch.cat([seq, feat[:, None]], dim=1)
    # flow-table bulk update, last write per slot wins: every lane writes
    # the value of the last lane of its slot (see the module docstring)
    last = _last_lane(gslot, pipes * ls)
    hf, tsf, gf = h.reshape(-1), ts.reshape(-1), granted.reshape(-1)

    def put(k, index, values):
        s[k] = table(k).index_put(index, values).view(states[k].shape)

    put("hash", (gslot,), hf[last])
    put("ring", (gslot, idx), feat[last])
    nxt = torch.where(idx + 1 == depth, 0, idx + 1).to(I32)
    put("buff_idx", (gslot,), nxt)
    put("last_ts", (gslot,), tsf[last])
    added = table("bklog_n").index_add(0, gslot, torch.ones_like(tsf))
    g_last = gf[last]
    s["bklog_n"] = added.index_put(
        (gslot,), torch.where(g_last, 0, added[gslot])).view(
            states["bklog_n"].shape)
    put("bklog_t", (gslot,), torch.where(g_last, tsf[last],
                                         table("bklog_t")[gslot]))
    s["flow_cnt"] = states["flow_cnt"] + is_new.sum(-1, dtype=I32)
    s["win_pkt_cnt"] = states["win_pkt_cnt"] + n
    cls = lanes(table("cls")[gslot])
    out = {"granted": granted, "slot": slot.to(I32), "hash": h,
           "payload": lanes(payload),
           "verdict": torch.where(cls >= 0, cls, -1), "is_new": is_new}
    tm.mark("table", ts)
    return s, out
