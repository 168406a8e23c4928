"""Vector I/O Processor (§5.1): the flow-identifier FIFO between the
switch and the Model Engine, as device-resident ring state.

Port of the single-pipe ops of ``repro/core/model_engine/vector_io.py``:
``IOConfig``, ``init_queues``, the host pair ``enqueue_batch`` /
``dequeue_batch`` (numpy, for the step-by-step host driver), and the
device ops ``ring_append``, ``ring_pop``, ``enqueue_device``,
``dequeue_device``, ``service_budget`` and ``step_budget``.  Device
dequeue returns fixed-shape lanes (``serve_lanes``) plus a count tensor,
so no shape depends on a device value and the device replay never reads
one back to the host.

The reference scatters with ``mode="drop"`` and gathers with
``mode="fill"``; PyTorch has neither, so appends scatter into a copy of
the field with one spare row at index ``cap`` (the drop target), and
pops clamp the index and zero the lanes past the count.

Pipes and engines (ports of the reference's pipe and engine-farm ops):
every ring op also takes a stack of rings, each field with a leading
dimension (the pipes' FIFOs [P, ...], the engines' ingress FIFOs [E,
...]) and head/tail/dropped [P]; a stack appends and pops ring by ring,
as the reference's ``vmap`` over pipes and engines does.
``pipe_shares`` splits one Model-Engine budget across the pipes' rings,
``engine_intake`` a step's routed lanes across the engines.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class IOConfig:
    queue_len: int = 1024
    feat_len: int = 9
    feat_dim: int = 2
    # static per-step dequeue lane count; None means queue_len, which
    # keeps the device dequeue bit-identical to the host loop
    serve_max: Optional[int] = None

    @property
    def serve_lanes(self) -> int:
        return self.queue_len if self.serve_max is None else self.serve_max


def init_queues(cfg: IOConfig, device=None) -> Dict[str, torch.Tensor]:
    def scalar():
        return torch.zeros((), dtype=I32, device=device)

    return {
        "id_q_slot": torch.zeros((cfg.queue_len,), dtype=I32, device=device),
        # uint32 flow hashes, held in int64
        "id_q_hash": torch.zeros((cfg.queue_len,), dtype=torch.int64,
                                 device=device),
        "feat_q": torch.zeros((cfg.queue_len, cfg.feat_len, cfg.feat_dim),
                              dtype=I32, device=device),
        "head": scalar(), "tail": scalar(), "dropped": scalar(),
    }


def enqueue_batch(q: Dict, cfg: IOConfig, slots: np.ndarray,
                  hashes: np.ndarray, feats: np.ndarray) -> Dict:
    """Host-side co-sim: append granted mirror packets in order; drop on
    overflow.  Reads the queue back, writes it to the same device."""
    head, tail = int(q["head"]), int(q["tail"])
    cap = cfg.queue_len
    out = {k: v.cpu().numpy().copy() for k, v in q.items()}
    dropped = int(q["dropped"])
    for i in range(len(slots)):
        if tail - head >= cap:
            dropped += 1
            continue
        pos = tail % cap
        out["id_q_slot"][pos] = slots[i]
        out["id_q_hash"][pos] = hashes[i]
        out["feat_q"][pos] = feats[i]
        tail += 1
    out["head"], out["tail"], out["dropped"] = (
        np.int32(v) for v in (head, tail, dropped))
    dev = q["head"].device
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in out.items()}


def dequeue_batch(q: Dict, cfg: IOConfig, n: int
                  ) -> Tuple[Dict, np.ndarray, np.ndarray, np.ndarray]:
    """Pop up to n entries in FIFO order (the ordering invariant of
    §5.1): (q', slots, hashes, feats) with numpy lanes."""
    head, tail = int(q["head"]), int(q["tail"])
    take = min(n, tail - head)
    idx = (head + np.arange(take)) % cfg.queue_len
    slots = q["id_q_slot"].cpu().numpy()[idx]
    hashes = q["id_q_hash"].cpu().numpy()[idx]
    feats = q["feat_q"].cpu().numpy()[idx]
    out = dict(q)
    out["head"] = torch.tensor(head + take, dtype=I32,
                               device=q["head"].device)
    return out, slots, hashes, feats


def stack_rows(head: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The leading index of a stack of rings (head [G]: one row a ring),
    () for one ring (0-d head)."""
    if head.dim() == 0:
        return ()
    return (torch.arange(head.shape[0], device=head.device)[:, None],)


def ring_append(fields: Dict[str, torch.Tensor],
                values: Dict[str, torch.Tensor], head: torch.Tensor,
                tail: torch.Tensor, dropped: torch.Tensor, cap: int,
                valid: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                           torch.Tensor]:
    """Masked append of ``values`` lanes into ring ``fields``: valid lanes
    pack in lane order, lanes that would overflow count into
    ``dropped``.  Returns (fields', tail', dropped').  A stack of G rings
    (head [G], fields [G, cap, ...], lanes [G, n]) appends ring by
    ring."""
    rank = torch.cumsum(valid.to(I32), -1, dtype=I32)
    fits = valid & (tail[..., None] + rank - head[..., None] <= cap)
    pos = torch.where(fits, torch.remainder(tail[..., None] + rank - 1,
                                            cap), cap).long()
    rows, d = stack_rows(head), head.dim()
    out = {}
    for k, f in fields.items():
        # spare row `cap` takes the drops
        buf = torch.cat([f, f.narrow(d, 0, 1)], dim=d)
        buf[rows + (pos,)] = values[k].to(f.dtype)
        out[k] = buf.narrow(d, 0, cap)
    n_in = fits.sum(-1, dtype=I32)
    n_dropped = (dropped + valid.sum(-1, dtype=I32) - n_in).to(I32)
    return out, (tail + n_in).to(I32), n_dropped


def ring_pop(fields: Dict[str, torch.Tensor], head: torch.Tensor,
             tail: torch.Tensor, cap: int, budget: torch.Tensor, lanes: int
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                        torch.Tensor]:
    """Pop min(budget, occupancy, lanes) entries in FIFO order: returns
    ([lanes]-shaped values, zero past the count; head'; count).  A stack
    of rings pops ring by ring ([G, lanes] values; ``budget`` 0-d or
    [G])."""
    take = torch.minimum(torch.minimum(budget.to(I32), tail - head),
                         torch.full_like(head, lanes))
    lane = torch.arange(lanes, dtype=I32, device=head.device)
    live = lane < take[..., None]
    idx = torch.remainder(head[..., None] + lane, cap).long()
    rows = stack_rows(head)
    vals = {}
    for k, f in fields.items():
        v = f[rows + (idx,)]
        mask = live.reshape(live.shape + (1,) * (v.dim() - live.dim()))
        vals[k] = torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                                   device=v.device))
    return vals, (head + take).to(I32), take


def service_budget(span_us: torch.Tensor, rate_per_us: float, cap: int
                   ) -> torch.Tensor:
    """Model-Engine inferences servable in ``span_us``:
    clip(floor(float32(span) * float32(rate)), 1, cap), as the
    reference's float32 formula."""
    rate = torch.full((), float(np.float32(rate_per_us)),
                      dtype=torch.float32, device=span_us.device)
    b = torch.floor(span_us.to(torch.float32) * rate)
    return torch.clamp(b, 1, cap).to(I32)


def step_budget(ts_first: torch.Tensor, ts_last: torch.Tensor,
                rate_per_us: float, cap: int) -> torch.Tensor:
    """Service budget of one step spanning [ts_first, ts_last]."""
    span = torch.clamp_min(ts_last.to(I32) - ts_first.to(I32), 1)
    return service_budget(span, rate_per_us, cap)


def enqueue_device(q: Dict, cfg: IOConfig, valid: torch.Tensor,
                   slots: torch.Tensor, hashes: torch.Tensor,
                   feats: torch.Tensor) -> Dict:
    """Masked vectorized enqueue with the host loop's FIFO/drop
    semantics."""
    fields = {k: q[k] for k in ("id_q_slot", "id_q_hash", "feat_q")}
    values = {"id_q_slot": slots, "id_q_hash": hashes, "feat_q": feats}
    out = dict(q)
    fields, out["tail"], out["dropped"] = ring_append(
        fields, values, q["head"], q["tail"], q["dropped"],
        cfg.queue_len, valid)
    out.update(fields)
    return out


def dequeue_device(q: Dict, cfg: IOConfig, budget: torch.Tensor
                   ) -> Tuple[Dict, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """Pop min(budget, occupancy, serve_lanes) entries in FIFO order:
    (q', slots, hashes, feats, count), lanes past count zero-filled."""
    vals, head, take = ring_pop(
        {k: q[k] for k in ("id_q_slot", "id_q_hash", "feat_q")},
        q["head"], q["tail"], cfg.queue_len, budget, cfg.serve_lanes)
    out = dict(q)
    out["head"] = head
    return (out, vals["id_q_slot"], vals["id_q_hash"], vals["feat_q"],
            take)


def occupancy(q: Dict) -> int:
    """Entries in a ring (a host read)."""
    return int(q["tail"]) - int(q["head"])


# -- the pipes' FIFOs ------------------------------------------------------

def init_pipes_queues(cfg: IOConfig, num_pipes: int, device=None
                      ) -> Dict[str, torch.Tensor]:
    """Per-pipe FIFOs: every queue field gains a leading [num_pipes]
    dimension."""
    one = init_queues(cfg, device=device)
    return {k: torch.stack([v] * num_pipes) for k, v in one.items()}


def pipe_shares(occ: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """Split one Model-Engine ``budget`` across pipes by ring occupancy
    [P]: every pipe first gets ``floor(budget * occ_p / sum(occ))``
    (capped at its occupancy), then the integer remainder waterfalls
    through the pipes in index order.  ``share_p <= occ_p`` and
    ``sum(share) == min(budget, sum(occ))``; one pipe gets ``min(budget,
    occ)``.  int32 throughout, as the reference computes it without x64
    (it widens the product only under ``jax_enable_x64``)."""
    occ = torch.clamp_min(occ.to(I32), 0)
    budget = budget.to(I32)
    total = occ.sum(dtype=I32)
    base = torch.minimum(torch.div(budget * occ, torch.clamp_min(total, 1),
                                   rounding_mode="floor").to(I32), occ)
    leftover = torch.clamp_min(budget - base.sum(dtype=I32), 0)
    room = occ - base
    before = torch.cumsum(room, 0, dtype=I32) - room   # room before pipe p
    extra = torch.minimum(torch.clamp_min(leftover - before, 0), room)
    return base + extra


def dequeue_pipes(q: Dict, cfg: IOConfig, shares: torch.Tensor
                  ) -> Tuple[Dict, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Drain each pipe's ring by its share: (q', slots [P, lanes], hashes
    [P, lanes], feats [P, lanes, ...], counts [P]), the [pipe, lane]
    layout keying results back to the owning pipe."""
    return dequeue_device(q, cfg, shares)


# -- the engine farm's ingress FIFOs (one per Model Engine) ----------------

def engine_capacity(cfg: IOConfig, num_pipes: int) -> int:
    """Per-engine ingress capacity: enough to absorb every pipe's ring."""
    return num_pipes * cfg.queue_len


def engine_serve_lanes(cfg: IOConfig, num_pipes: int) -> int:
    """Lanes one engine serves a step: every pipe's dequeue
    (``serve_lanes`` each), so one engine never leaves a routed lane
    waiting."""
    return num_pipes * cfg.serve_lanes


def init_engine_queues(cfg: IOConfig, num_engines: int, num_pipes: int,
                       device=None) -> Dict[str, torch.Tensor]:
    """Per-engine ingress FIFOs [E, ...]: (slot, hash, feat, owning pipe)
    entries."""
    cap = engine_capacity(cfg, num_pipes)

    def lanes(*shape, dtype=I32):
        return torch.zeros((num_engines, cap) + shape, dtype=dtype,
                           device=device)

    def scalar():
        return torch.zeros((num_engines,), dtype=I32, device=device)

    return {"eq_slot": lanes(), "eq_hash": lanes(dtype=torch.int64),
            "eq_feat": lanes(cfg.feat_len, cfg.feat_dim),
            "eq_pipe": lanes(),
            "head": scalar(), "tail": scalar(), "dropped": scalar()}


def engine_free(eq: Dict, cfg: IOConfig, num_pipes: int) -> torch.Tensor:
    """Remaining ingress space of each engine's queue."""
    return engine_capacity(cfg, num_pipes) - (eq["tail"] - eq["head"])


def engine_intake(free: torch.Tensor, n_lanes: torch.Tensor
                  ) -> torch.Tensor:
    """Split ``n_lanes`` routed lanes across engines by free ingress space
    [E]: ``pipe_shares`` with engines as the consumers (the least-loaded
    engine takes the most lanes; never more than an engine's space)."""
    return pipe_shares(free, n_lanes)


_ENGINE_FIELDS = ("eq_slot", "eq_hash", "eq_feat", "eq_pipe")


def enqueue_engine(eq: Dict, cfg: IOConfig, num_pipes: int,
                   valid: torch.Tensor, slots: torch.Tensor,
                   hashes: torch.Tensor, feats: torch.Tensor,
                   pipes: torch.Tensor) -> Dict:
    """Masked append into the engines' ingress rings (lanes [E, n], or
    [n] for one engine's ring), FIFO/drop semantics."""
    values = dict(zip(_ENGINE_FIELDS, (slots, hashes, feats, pipes)))
    out = dict(eq)
    fields, out["tail"], out["dropped"] = ring_append(
        {k: eq[k] for k in _ENGINE_FIELDS}, values, eq["head"], eq["tail"],
        eq["dropped"], engine_capacity(cfg, num_pipes), valid)
    out.update(fields)
    return out


def dequeue_engine(eq: Dict, cfg: IOConfig, num_pipes: int,
                   budget: torch.Tensor
                   ) -> Tuple[Dict, torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """Pop min(budget, occupancy, serve lanes) ingress entries of each
    engine, FIFO order: (eq', slots, hashes, feats, pipes, count), lanes
    ``engine_serve_lanes`` wide and zero past the count."""
    vals, head, take = ring_pop(
        {k: eq[k] for k in _ENGINE_FIELDS}, eq["head"], eq["tail"],
        engine_capacity(cfg, num_pipes), budget,
        engine_serve_lanes(cfg, num_pipes))
    out = dict(eq)
    out["head"] = head
    return (out, *(vals[k] for k in _ENGINE_FIELDS), take)
