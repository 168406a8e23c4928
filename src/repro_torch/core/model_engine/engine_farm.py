"""Model-Engine farm (§7 scale-out): E FPGA engines behind one switch.

Port of ``repro/core/model_engine/engine_farm.py``.  Each pipe's Data
Engine and Vector-I/O ring stay as in the multi-pipe driver; the pipes'
dequeued lanes are routed to per-engine ingress FIFOs by free ingress
space (``vio.engine_intake``: the least-loaded engine takes the most
lanes, never more than it has room for), every engine drains its queue
against its own budget (the single-engine ``vio.step_budget``), and the
verdicts return through the owning pipe's delay line, tagged with the
serving engine.

The reference writes its step per (pipe, engine) cell and runs it under
``shard_map`` on a 2-D (pipe, engine) device mesh (``farm_mesh``) or a
nested ``vmap`` below P x E devices; that vmap is its semantics and the
oracle of this port.  Here pipes and engines are leading tensor
dimensions on one device, and there is no counterpart of ``farm_mesh``:
each ``all_gather`` is the stacked tensor itself and each
``axis_index`` an ``arange``.  The pipes' switch stage runs once over
[P, ...], the engines' service once over [E, ...] (one INT8 GEMM a layer
for all engines' lanes), and the one lane exchange is a gather of the
pipes' dequeued lanes by the route each engine takes.

``num_engines=1`` forced through the farm is bit-identical to the pipes
driver: the single engine's ingress queue passes everything through
within the step and its budget is the pipes driver's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch import _telemetry as tm
from repro_torch.core.data_engine import rate_limiter as rl
from repro_torch.core.model_engine import delay_line as dl
from repro_torch.core.model_engine import vector_io as vio

I32 = torch.int32

# engine ingress queue-depth histogram: log2 buckets 0, 1, 2-3, 4-7, ...
DEPTH_BUCKETS = 16
_DEPTH_EDGES = np.asarray([1 << b for b in range(DEPTH_BUCKETS - 1)],
                          np.int64)


def depth_histogram(depths: np.ndarray, num_engines: int
                    ) -> List[List[int]]:
    """Per-engine log2 histogram of ingress queue-depth samples
    [n_samples, num_engines]: bucket b counts depths in [2^(b-1), 2^b)
    (bucket 0 is depth 0), saturating at the last bucket."""
    depths = np.asarray(depths, np.int64).reshape(-1, num_engines)
    hist = np.zeros((num_engines, DEPTH_BUCKETS), np.int64)
    for e in range(num_engines):
        b = np.searchsorted(_DEPTH_EDGES, depths[:, e], side="right")
        hist[e] = np.bincount(b, minlength=DEPTH_BUCKETS)
    return hist.tolist()


def route_ranks(shares: torch.Tensor, lanes: int, start: torch.Tensor,
                take: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map an engine's intake ranks to (pipe, lane, valid) coordinates.

    The step's routed lanes form one pipe-major sequence: pipe p's
    ``shares[p]`` dequeued lanes hold ranks [offset_p, offset_p +
    shares[p]).  An engine takes ranks [start, start + take); each of its
    ``lanes`` intake positions maps back to its (pipe, lane-in-pipe).
    ``start``/``take`` [E] give every engine's at once ([E, lanes])."""
    csum = torch.cumsum(shares.to(I32), 0, dtype=I32)
    offs = csum - shares
    k = torch.arange(lanes, dtype=I32, device=shares.device)
    rank = start.to(I32)[..., None] + k
    pipe = torch.searchsorted(csum, rank, right=True)
    pipe_c = torch.clamp_max(pipe, shares.shape[0] - 1)
    lane = rank - offs[pipe_c]
    return pipe_c.to(I32), lane, k < take[..., None]


def gather_results(res_pipe: torch.Tensor, res_n: torch.Tensor,
                   my_pipe: torch.Tensor,
                   values: Tuple[torch.Tensor, ...]
                   ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Select a pipe's results from the farm's [E, S] output: flattened
    engine-major (engine order, then each engine's service order), the
    lanes owned by ``my_pipe`` packed to the front; returns the packed
    [E * S] values and their count.  ``my_pipe`` [P] selects every pipe's
    at once ([P, E * S] values, [P] counts)."""
    e, s = res_pipe.shape
    dev = res_pipe.device
    lane_ok = torch.arange(s, device=dev)[None, :] < res_n[:, None]
    mine = (lane_ok & (res_pipe == my_pipe[..., None, None])).reshape(
        my_pipe.shape + (e * s,))
    rank = torch.cumsum(mine.to(I32), -1, dtype=I32)
    dest = torch.where(mine, rank - 1, e * s).long()
    rows = vio.stack_rows(my_pipe)
    packed = []
    for v in values:
        # spare column e * s takes the lanes of other pipes
        buf = torch.zeros(my_pipe.shape + (e * s + 1,), dtype=v.dtype,
                          device=dev)
        buf[rows + (dest,)] = v.reshape(-1).expand(mine.shape)
        packed.append(buf[..., :e * s])
    return tuple(packed), mine.sum(-1, dtype=I32)


def freeze(new: Tuple[dict, ...], old: Tuple[dict, ...],
           active: torch.Tensor) -> Tuple[dict, ...]:
    """``where(active, new, old)`` leaf by leaf over stacked [P, ...]
    dicts: the pipes whose streams ran out keep their state."""
    def sel(nu, o):
        if nu is o:
            return o
        return torch.where(active.view((-1,) + (1,) * (nu.dim() - 1)),
                           nu, o)

    return tuple({k: sel(nd[k], od[k]) for k in od}
                 for nd, od in zip(new, old))


def merge_view(de_out, carry, active):
    """The pipe-local stage's result as the merge sees it: (the carry,
    frozen where a pipe is not ``active``; ring occupancies [P]; batch
    starts and ends [P], masked to +inf / -inf where frozen; aux).
    ``active=None``: every pipe is active (the unmasked step)."""
    state, queues, dline, aux = de_out
    if active is None:
        return ((state, queues, dline), queues["tail"] - queues["head"],
                aux["ts_first"], aux["now"], aux)
    state, queues, dline = freeze((state, queues, dline), carry, active)
    i32 = torch.iinfo(I32)
    occ = (queues["tail"] - queues["head"]) * active.to(I32)
    lo = torch.where(active, aux["ts_first"], i32.max)
    hi = torch.where(active, aux["now"], i32.min)
    return (state, queues, dline), occ, lo, hi, aux


def make_farm_step(num_pipes: int, num_engines: int, iocfg: vio.IOConfig,
                   base_rate_per_us: float, loop_latency_us: int,
                   de_local, model, local_cfg):
    """One step of the farm driver: P pipes feeding E engines.

    ``de_local`` is the pipes' Data-Engine stage (``fenix._make_pipe_local``
    with the local config); ``base_rate_per_us`` the SINGLE-engine rate,
    each engine's own budget, so ``num_engines=1`` reproduces the pipes
    driver's budget.  ``step_fn(carry, chunk, cp, active=None)`` takes
    the carry (pstate, pqueues, pdl, eq), a chunk of [P, B] lanes, the
    control-plane flag (the T_w rebuild of every pipe, frozen ones too)
    and the pipes still streaming (``active`` [P] bool; None: all, the
    unmasked step).  A frozen pipe keeps its switch state and merge
    weight 0; the engines keep draining, and results owned by a frozen
    pipe still enter its delay line, due at the farm-wide clock (the
    latest active pipe's).  Returns (carry', verdicts [P, B], stats [4]
    (granted, served, classified, tree), served [E], depths [E])."""
    lanes = iocfg.serve_lanes
    serve = vio.engine_serve_lanes(iocfg, num_pipes)

    def step_fn(carry, chunk, cp: bool, active=None):
        dev = chunk["ts_us"].device
        de_out = de_local(*carry[:3], chunk)
        (pstate, pq, pdl), occ, lo, hi, aux = merge_view(de_out, carry[:3],
                                                         active)
        eq = carry[3]
        hi = hi.max()
        # the per-engine service budget (the farm's one step_budget site)
        ebudget = vio.step_budget(lo.min(), hi, base_rate_per_us,
                                  num_pipes * iocfg.queue_len)
        free = vio.engine_free(eq, iocfg, num_pipes)            # [E]
        # pipes dequeue against the pooled budget, capped by the total
        # ingress space, so the router can place every lane
        shares = vio.pipe_shares(occ, torch.minimum(
            num_engines * ebudget, free.sum(dtype=I32)))
        counts = torch.clamp_max(shares, lanes)     # the actual dequeues
        pq, s_de, h_de, f_de, _ = vio.dequeue_pipes(pq, iocfg, shares)
        # route the lanes to the engines (the reference's lane gather)
        intake = vio.engine_intake(free, counts.sum(dtype=I32))  # [E]
        start = torch.cumsum(intake, 0, dtype=I32) - intake
        pipe_of, lane_of, valid = route_ranks(counts, serve, start, intake)
        flat = torch.clamp(pipe_of * lanes + lane_of, 0,
                           num_pipes * lanes - 1).long()
        eq = vio.enqueue_engine(
            eq, iocfg, num_pipes, valid, s_de.reshape(-1)[flat],
            h_de.reshape(-1)[flat],
            f_de.reshape((num_pipes * lanes,) + f_de.shape[2:])[flat],
            pipe_of)
        # each engine's service
        eq, es, eh, ef, ep, srv = vio.dequeue_engine(eq, iocfg, num_pipes,
                                                     ebudget)
        tm.mark("dequeue", srv)
        ecls = model.infer_engines(ef)
        tm.mark("infer", srv)
        depth = eq["tail"] - eq["head"]
        # results return through the owning pipe's delay line
        eng = torch.arange(num_engines, dtype=I32, device=dev)[:, None] \
            .expand(es.shape)
        (sel_s, sel_h, sel_c, sel_e), my_cnt = gather_results(
            ep, srv, torch.arange(num_pipes, dtype=I32, device=dev),
            (es, eh, ecls, eng))
        now = aux["now"] if active is None else torch.where(active,
                                                            aux["now"], hi)
        pdl = dl.push_pipes(pdl, now + loop_latency_us, sel_s, sel_h, sel_c,
                            my_cnt, engines=sel_e)
        tm.mark("push", srv)
        if cp:
            pstate = rl.control_plane_update_pipes(pstate, local_cfg)
            tm.mark("control_plane", srv)
        pstats = torch.stack([aux["granted"], aux["classified"],
                              aux["n_tree"]])
        if active is not None:
            pstats = pstats * active.to(I32)
        pstats = pstats.sum(-1)
        stats = torch.stack([pstats[0], srv.sum(), pstats[1], pstats[2]])
        return (pstate, pq, pdl, eq), aux["verdict"], stats, srv, depth

    return step_fn


def make_farm_tail(num_pipes: int, num_engines: int, iocfg: vio.IOConfig,
                   base_rate_per_us: float, loop_latency_us: int,
                   de_local, model):
    """A pipe's tail step in the farm: its trailing (< batch) packets,
    its own ring drained against its 1/num_pipes share of every engine's
    budget, the lanes served directly (the scan is over: no later step
    would drain an ingress queue) but split across the engines by the
    same waterfall, each tagged with its engine.  ``tail_fn(carry,
    chunk)`` on one pipe's (state, queues, dline) returns (carry',
    verdicts, stats [4], lanes a engine [E]).  ``num_engines=1`` is the
    pipes driver's tail step."""
    tail_rate = base_rate_per_us / num_pipes

    def tail_fn(carry, chunk):
        state, queues, dline, aux = de_local(*carry, chunk)
        ebudget = vio.step_budget(aux["ts_first"], aux["now"], tail_rate,
                                  iocfg.queue_len)
        queues, s2, h2, f2, cnt = vio.dequeue_device(
            queues, iocfg, num_engines * ebudget)
        assign = vio.engine_intake(ebudget.expand(num_engines), cnt)
        tags = torch.searchsorted(
            torch.cumsum(assign, 0, dtype=I32),
            torch.arange(s2.shape[0], dtype=I32, device=s2.device),
            right=True)
        tags = torch.clamp_max(tags, num_engines - 1).to(I32)
        tm.mark("dequeue", cnt)
        cls = model.infer(f2)
        tm.mark("infer", cnt)
        dline = dl.push(dline, aux["now"] + loop_latency_us, s2, h2, cls,
                        cnt, engines=tags)
        tm.mark("push", cnt)
        stats = torch.stack([aux["granted"], cnt, aux["classified"],
                             aux["n_tree"]])
        return (state, queues, dline), aux["verdict"], stats, assign

    return tail_fn
