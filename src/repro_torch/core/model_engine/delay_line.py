"""Inference-result delay line: the switch<->FPGA loop latency as
device-resident ring state.

Port of ``init``, ``push``, ``deliver`` and ``to_list`` from
``repro/core/model_engine/delay_line.py``.  Results are pushed when the
Model Engine finishes a batch and written to the flow table once their
delivery time has passed.  Among duplicate slots the last queued result
wins (``write_results``): a stable sort by slot and a last-of-run
selection leave unique scatter indices, so the write is the same on
every device.  The host driver's in-flight list applies its due results
through the same function.

Pipes: each pipeline has its own return path, so the multi-pipe driver
keeps a stack of delay lines [P, ...] (``init_pipes``); ``push`` and
``deliver`` take the stack and work pipe by pipe (``push_pipes`` and
``deliver_pipes`` name them), delivery into each pipe's own table.  The
engine farm tags each entry with the engine that served it (``eng``);
the single-engine paths write 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.model_engine.vector_io import ring_append

I32 = torch.int32


def init(capacity: int, device=None) -> Dict[str, torch.Tensor]:
    def lanes(dtype=I32):
        return torch.zeros((capacity,), dtype=dtype, device=device)

    def scalar():
        return torch.zeros((), dtype=I32, device=device)

    return {"t": lanes(), "slot": lanes(),
            "hash": lanes(torch.int64),       # uint32 values in int64
            "cls": lanes(),
            "eng": lanes(),                   # engine-farm tag (0 here)
            "head": scalar(), "tail": scalar(), "dropped": scalar()}


def init_pipes(capacity: int, num_pipes: int, device=None
               ) -> Dict[str, torch.Tensor]:
    """Per-pipe delay lines: every field gains a leading [num_pipes]
    dimension."""
    one = init(capacity, device=device)
    return {k: torch.stack([v] * num_pipes) for k, v in one.items()}


def push(dl: Dict, deliver_ts: torch.Tensor, slots: torch.Tensor,
         hashes: torch.Tensor, cls: torch.Tensor, count: torch.Tensor,
         engines: Optional[torch.Tensor] = None) -> Dict:
    """Append the first ``count`` lanes, due at ``deliver_ts`` (0-d, or
    one time per lane), tagged with the engines that served them
    (``engines``, default 0).  A stack of lines takes lanes [P, n], a
    count and a time a pipe [P]."""
    cap = dl["t"].shape[-1]
    n = slots.shape[-1]
    valid = torch.arange(n, dtype=I32, device=slots.device) \
        < count[..., None]
    t = deliver_ts.to(I32)
    if t.dim() < slots.dim():                 # one time a line
        t = t[..., None]
    fields = {k: dl[k] for k in ("t", "slot", "hash", "cls", "eng")}
    values = {"t": t.expand(slots.shape), "slot": slots,
              "hash": hashes, "cls": cls,
              "eng": (torch.zeros_like(slots, dtype=I32) if engines is None
                      else engines)}
    out = dict(dl)
    fields, out["tail"], out["dropped"] = ring_append(
        fields, values, dl["head"], dl["tail"], dl["dropped"], cap, valid)
    out.update(fields)
    return out


def deliver(state: Dict, dl: Dict, now: torch.Tensor, n_slots: int
            ) -> Tuple[Dict, Dict]:
    """Apply every queued result with deliver_ts <= now to the flow table
    (write ``cls`` only where the slot still holds the same hash).  A
    stack of lines delivers into a stacked state [P, n_slots], pipe p's
    results at its own clock ``now[p]`` into its own table."""
    cap = dl["t"].shape[-1]
    lane = torch.arange(cap, dtype=I32, device=now.device)
    in_q = lane < (dl["tail"] - dl["head"])[..., None]
    idx = torch.remainder(dl["head"][..., None] + lane, cap).long()
    t, slots, hashes, cls = (torch.take_along_dim(dl[k], idx, dim=-1)
                             for k in ("t", "slot", "hash", "cls"))
    slots = slots.long()
    due = in_q & (t <= now.to(I32)[..., None])
    if now.dim() == 0:
        new_state = write_results(state, slots, hashes, cls, due, n_slots)
    else:
        # the pipes' tables as one global table: pipe p's slot s at
        # p * n_slots + s, so no slot is shared across pipes and the
        # last-wins order within a pipe is its lane order
        pipes = now.shape[0]
        glob = slots + n_slots * torch.arange(pipes, device=now.device)[
            :, None]
        flat = write_results(
            {k: state[k].reshape(-1) for k in ("hash", "cls")},
            glob.reshape(-1), hashes.reshape(-1), cls.reshape(-1),
            due.reshape(-1), pipes * n_slots)
        new_state = dict(state)
        new_state["cls"] = flat["cls"].view(state["cls"].shape)
    out = dict(dl)
    out["head"] = (dl["head"] + due.sum(-1, dtype=I32)).to(I32)
    return new_state, out


push_pipes = push            # a stack of lines: one line a pipe
deliver_pipes = deliver


def write_results(state: Dict, slots: torch.Tensor, hashes: torch.Tensor,
                  cls: torch.Tensor, mask: torch.Tensor, n_slots: int
                  ) -> Dict:
    """Write the results of the ``mask`` lanes to the flow table, in lane
    order: ``cls`` lands only where the slot still holds the same hash,
    and of several lanes of one slot the last such lane wins — as if
    ``flow_tracker.apply_inference_result`` ran lane by lane."""
    apply = mask & (state["hash"][slots] == hashes)
    # deterministic last-wins: stable-sort lanes by slot (sentinel for
    # lanes that do not apply), keep the last lane of each run
    skey = torch.where(apply, slots, n_slots)
    order = torch.argsort(skey, stable=True)
    s_sorted = skey[order]
    is_last = torch.ones_like(s_sorted, dtype=torch.bool)
    is_last[:-1] = s_sorted[1:] != s_sorted[:-1]
    tgt = torch.where(is_last & (s_sorted < n_slots), s_sorted, n_slots)
    buf = torch.cat([state["cls"], state["cls"][:1]])   # spare drop row
    buf[tgt] = cls[order].to(I32)
    new_state = dict(state)
    new_state["cls"] = buf[:n_slots]
    return new_state


def to_list(dl: Dict) -> List[Tuple[int, int, int, int]]:
    """Drain to the host driver's in-flight list, in ring order:
    [(deliver_ts, slot, hash, cls)] as Python ints."""
    head, tail = int(dl["head"]), int(dl["tail"])
    cap = dl["t"].shape[0]
    idx = (head + np.arange(tail - head)) % cap
    cols = [dl[k].cpu().numpy()[idx] for k in ("t", "slot", "hash", "cls")]
    return [tuple(int(c[i]) for c in cols) for i in range(len(idx))]
