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
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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


def push(dl: Dict, deliver_ts: torch.Tensor, slots: torch.Tensor,
         hashes: torch.Tensor, cls: torch.Tensor, count: torch.Tensor
         ) -> Dict:
    """Append the first ``count`` lanes, due at ``deliver_ts`` (0-d, or
    one time per lane)."""
    cap = dl["t"].shape[0]
    n = slots.shape[0]
    valid = torch.arange(n, dtype=I32, device=slots.device) < count
    fields = {k: dl[k] for k in ("t", "slot", "hash", "cls", "eng")}
    values = {"t": deliver_ts.to(I32).expand(n), "slot": slots,
              "hash": hashes, "cls": cls,
              "eng": torch.zeros((n,), dtype=I32, device=slots.device)}
    out = dict(dl)
    fields, out["tail"], out["dropped"] = ring_append(
        fields, values, dl["head"], dl["tail"], dl["dropped"], cap, valid)
    out.update(fields)
    return out


def deliver(state: Dict, dl: Dict, now: torch.Tensor, n_slots: int
            ) -> Tuple[Dict, Dict]:
    """Apply every queued result with deliver_ts <= now to the flow table
    (write ``cls`` only where the slot still holds the same hash)."""
    cap = dl["t"].shape[0]
    lane = torch.arange(cap, dtype=I32, device=now.device)
    in_q = lane < (dl["tail"] - dl["head"])
    idx = torch.remainder(dl["head"] + lane, cap).long()
    t = dl["t"][idx]
    slots = dl["slot"][idx].long()
    hashes = dl["hash"][idx]
    cls = dl["cls"][idx]
    due = in_q & (t <= now.to(I32))
    new_state = write_results(state, slots, hashes, cls, due, n_slots)
    out = dict(dl)
    out["head"] = (dl["head"] + due.sum(dtype=I32)).to(I32)
    return new_state, out


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
