"""Plain PyTorch reference of one FENIX trace replay.

A frozen, self-contained restatement of what ``FenixSystem.run_trace``
computes on its device and farm drivers: the switch's Data Engine (flow
table by 5-tuple hash, slot claim, the probabilistic token-bucket gate,
the feature rings), the Vector-I/O FIFOs with the Model Engine's service
budget, the INT8 FENIX-CNN or FENIX-RNN, the loop-latency delay line and
the control-plane LUT rebuild at each T_w boundary; on the farm also the
routing of packets to pipes, the occupancy shares, the engines' ingress
FIFOs and the engine router.  It imports nothing of the program: every
rule, constant and default it needs is written out here, op for op in
the integer and float32 arithmetic the program states, so both give the
same verdicts bit for bit.

The single-pipe device driver is the farm of one pipe and one engine:
``replay`` runs every cell through the same pipe-major loop.  One chunk
step is written once, over a stack of pipes [P, B] (P = 1 on the device
driver).  Nothing here is fused or captured; every op runs eagerly on
whichever device the tensors live on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
M32 = 0xFFFFFFFF

# packet fields the data plane reads (the five-tuple is uint32, held in
# int64)
PKT_KEYS = ("src_ip", "dst_ip", "src_port", "dst_port", "proto", "ts_us",
            "pkt_len")
DEPTH_BUCKETS = 16
# the stats a replay reports, in the program's names
STAT_KEYS = ("packets", "granted", "inferences", "classified_pkts",
             "tree_pkts", "dropped_q", "dropped_inflight",
             "served_per_engine", "dropped_eq", "engine_q_depth_hist")


@dataclasses.dataclass(frozen=True)
class Switch:
    """The switch and link settings the program runs with by default
    (one Model Engine, one pipe)."""
    n_slots_log2: int = 12
    ring_depth: int = 8
    feat_dim: int = 2
    fpga_hz: float = 75e6
    link_bw_bytes: float = 12.5e9
    feat_bytes: int = 64
    bucket_queue_len: int = 64      # the bucket's cap in grants
    window_us: int = 1_000_000      # T_w
    t_shift: int = 10
    c_shift: int = 0
    t_bins: int = 64
    c_bins: int = 32
    prob_bits: int = 16
    io_queue_len: int = 1024        # Vector-I/O FIFO, and lanes served
    feat_len: int = 9
    loop_latency_us: int = 3
    n_est: float = 1000.0
    q_est_pps: float = 1e6

    def rate_per_us(self, fpga_hz: float, link: float) -> float:
        return min(fpga_hz, link / max(self.feat_bytes, 1)) / 1e6


@dataclasses.dataclass(frozen=True)
class Layout:
    """A cell's driver layout: batch a pipe, LUT cadence, P pipes, E
    engines, and the rates every stage derives from them."""
    sw: Switch
    batch: int
    cpe: int
    pipes: int = 1
    engines: int = 1

    @property
    def local_slots_log2(self) -> int:
        return self.sw.n_slots_log2 - (self.pipes.bit_length() - 1)

    @property
    def local_rate(self) -> float:
        """One pipe's share of the pool's admission rate (per us)."""
        e, p = self.engines, self.pipes
        return self.sw.rate_per_us(self.sw.fpga_hz * e / p,
                                   self.sw.link_bw_bytes * e / p)

    @property
    def engine_rate(self) -> float:
        """One engine's service rate (per us)."""
        return self.sw.rate_per_us(self.sw.fpga_hz, self.sw.link_bw_bytes)

    @property
    def cost_us(self) -> int:
        return max(1, int(round(1.0 / self.local_rate)))

    @property
    def bucket_cap(self) -> int:
        return self.sw.bucket_queue_len * self.cost_us


# -- threefry, as jax.random draws it --------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _threefry(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = (((x[1] << r) | (x[1] >> (32 - r))) & M32) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32
    return x[0], x[1]


def _iota(key: torch.Tensor, n: int):
    lo = torch.arange(n, dtype=I64, device=key.device)
    return _threefry(key[..., 0, None], key[..., 1, None],
                     torch.zeros_like(lo), lo)


def key_split(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.random.split(key) of keys [..., 2]: (key', subkey)."""
    b1, b2 = _iota(key, 2)
    keys = torch.stack([b1, b2], dim=-1)
    return keys[..., 0, :], keys[..., 1, :]


def randint_pow2(key: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """jax.random.randint(key, (n,), 0, 2^bits) for keys [..., 2]: a
    power-of-two span draws from the second split key's bits alone."""
    _, k2 = key_split(key)
    b1, b2 = _iota(k2, n)
    return ((b1 ^ b2) % (1 << bits)).to(I32)


def five_tuple_hash(pk: Dict[str, torch.Tensor]) -> torch.Tensor:
    """32-bit mix of the 5-tuple; 0 is kept for an empty slot."""
    h = mul_u32(pk["src_ip"], 0x9E3779B1)
    h = h ^ mul_u32(pk["dst_ip"], 0x85EBCA77)
    h = h ^ mul_u32(pk["src_port"], 0xC2B2AE3D)
    h = h ^ mul_u32(pk["dst_port"], 0x27D4EB2F)
    h = h ^ mul_u32(pk["proto"], 0x165667B1)
    h = h ^ (h >> 15)
    h = mul_u32(h, 0x2545F491)
    h = h ^ (h >> 13)
    return torch.clamp_min(h, 1)


# -- the admission LUT (Eq. 2) ---------------------------------------------

def initial_lut(n: float, q: float, v: float, sw: Switch) -> np.ndarray:
    """The control plane's first LUT, in float64 numpy."""
    t = (np.arange(sw.t_bins) + 0.5) * (1 << sw.t_shift)
    c = (np.arange(sw.c_bins) + 0.5) * (1 << sw.c_shift)
    t, c = np.meshgrid(t, c, indexing="ij")
    c = np.maximum(c, 1e-12)
    denom = q * t - n * c
    slow = c * (v * t - n) / np.where(np.abs(denom) < 1e-9, np.inf, denom)
    fast = t * (v * c - q) / np.where(np.abs(denom) < 1e-9, np.inf, -denom)
    p = np.where(denom > 1e-9, slow, np.where(denom < -1e-9, fast,
                 (t >= n / v).astype(np.float64)))
    p = np.clip(p, 0.0, 1.0)
    return np.round(p * ((1 << sw.prob_bits) - 1)).astype(np.int32)


def _f32(x, dev) -> torch.Tensor:
    return torch.full((), float(np.float32(x)), dtype=F32, device=dev)


def rebuilt_lut(flow_cnt: torch.Tensor, pkt_cnt: torch.Tensor, v: float,
                sw: Switch) -> torch.Tensor:
    """The T_w rebuild from the window counters [P], in float32, one
    eager op at a time (no fused multiply-add): LUTs [P, TB, CB]."""
    dev = flow_cnt.device
    one = _f32(1.0, dev)
    n = torch.maximum(flow_cnt.to(F32), one)[..., None, None]
    q = (torch.maximum(pkt_cnt.to(F32), one)
         / _f32(max(float(sw.window_us), 1.0), dev))[..., None, None]
    ti = (torch.arange(sw.t_bins, dtype=F32, device=dev) + 0.5) \
        * (1 << sw.t_shift)
    cj = (torch.arange(sw.c_bins, dtype=F32, device=dev) + 0.5) \
        * (1 << sw.c_shift)
    t, c = torch.meshgrid(ti, cj, indexing="ij")
    v = _f32(v, dev)
    eps, inf = _f32(1e-9, dev), _f32(np.inf, dev)
    c = torch.maximum(c, _f32(1e-12, dev))
    denom = q * t - n * c
    small = torch.abs(denom) < eps
    slow = c * (v * t - n) / torch.where(small, inf, denom)
    fast = t * (v * c - q) / torch.where(small, inf, -denom)
    p = torch.where(denom > eps, slow,
                    torch.where(denom < -eps, fast, (t >= n / v).to(F32)))
    p = torch.clamp(p, 0.0, 1.0)
    return torch.round(p * ((1 << sw.prob_bits) - 1)).to(I32)


# -- state -----------------------------------------------------------------

def init_carry(lay: Layout, dev) -> Tuple[Dict, ...]:
    """Fresh stacked carry: (switch state [P, ...], pipe FIFOs [P, ...],
    delay lines [P, ...], engine FIFOs [E, ...])."""
    sw, P, E = lay.sw, lay.pipes, lay.engines
    ls = 1 << lay.local_slots_log2
    lut = initial_lut(sw.n_est / P, sw.q_est_pps / P / 1e6, lay.local_rate,
                      sw)

    def z(*shape, dtype=I32, fill=0):
        return torch.full((P,) + shape, fill, dtype=dtype, device=dev)

    state = {"hash": z(ls, dtype=I64), "bklog_n": z(ls), "bklog_t": z(ls),
             "cls": z(ls, fill=-1), "buff_idx": z(ls), "pkt_cnt": z(ls),
             "last_ts": z(ls), "ring": z(ls, sw.ring_depth, sw.feat_dim),
             "bucket": z(fill=lay.bucket_cap), "t_last": z(),
             "lut": torch.from_numpy(np.stack([lut] * P)).to(dev),
             "flow_cnt": z(), "win_pkt_cnt": z(), "win_start": z(),
             "rng_key": torch.tensor([[0, p] for p in range(P)], dtype=I64,
                                     device=dev),
             "granted": z(), "denied_prob": z(), "denied_tokens": z(),
             "collisions": z()}
    q = sw.io_queue_len
    queues = {"id_q_slot": z(q), "id_q_hash": z(q, dtype=I64),
              "feat_q": z(q, sw.feat_len, sw.feat_dim), "head": z(),
              "tail": z(), "dropped": z()}
    dline = {k: z(q * E, dtype=I64 if k == "hash" else I32)
             for k in ("t", "slot", "hash", "cls", "eng")}
    dline.update(head=z(), tail=z(), dropped=z())
    cap = P * q

    def ze(*shape, dtype=I32):
        return torch.zeros((E,) + shape, dtype=dtype, device=dev)

    eq = {"eq_slot": ze(cap), "eq_hash": ze(cap, dtype=I64),
          "eq_feat": ze(cap, sw.feat_len, sw.feat_dim), "eq_pipe": ze(cap),
          "head": ze(), "tail": ze(), "dropped": ze()}
    return state, queues, dline, eq


# -- the Data Engine, a stack of pipes in one pass ----------------------------

def _first_lane(g: torch.Tensor, n_slots: int) -> torch.Tensor:
    lane = torch.arange(g.shape[0], dtype=I64, device=g.device)
    first = torch.full((n_slots,), g.shape[0], dtype=I64, device=g.device)
    return first.scatter_reduce(0, g, lane, reduce="amin")[g] == lane


def _last_lane(g: torch.Tensor, n_slots: int) -> torch.Tensor:
    lane = torch.arange(g.shape[0], dtype=I64, device=g.device)
    last = torch.full((n_slots,), -1, dtype=I64, device=g.device)
    return last.scatter_reduce(0, g, lane, reduce="amax")[g]


def _rank_in_slot(g: torch.Tensor) -> torch.Tensor:
    """Earlier lanes of the batch on the same slot."""
    n = g.shape[0]
    order = torch.argsort(g, stable=True)
    s = g[order]
    idx = torch.arange(n, dtype=I64, device=g.device)
    start = torch.ones(n, dtype=torch.bool, device=g.device)
    start[1:] = s[1:] != s[:-1]
    first = torch.cummax(torch.where(start, idx, 0), dim=0).values
    run = torch.empty(n, dtype=I32, device=g.device)
    run[order] = (idx - first).to(I32)
    return run


def data_engine(st: Dict, pk: Dict, lay: Layout) -> Tuple[Dict, Dict]:
    """Pipe p's batch pk[..][p] on pipe p's table, bucket and key."""
    sw = lay.sw
    P, n = pk["ts_us"].shape
    ls = 1 << lay.local_slots_log2
    ts = pk["ts_us"]
    h = five_tuple_hash(pk)
    slot = h & (ls - 1)
    g = (slot + ls * torch.arange(P, device=h.device)[:, None]).reshape(-1)

    def tab(k):
        return st[k].reshape((P * ls,) + st[k].shape[2:])

    def lanes(x):
        return x.reshape((P, n) + x.shape[1:])

    stored = lanes(tab("hash")[g])
    is_new = lanes(_first_lane(g, P * ls)) & ((stored == 0) | (stored != h))
    t_i = torch.clamp_min(ts - lanes(tab("bklog_t")[g]), 0)
    c_i = torch.clamp_min(lanes(tab("bklog_n")[g]), 0) \
        + lanes(_rank_in_slot(g))
    key, sub = key_split(st["rng_key"])
    rand = randint_pow2(sub, n, sw.prob_bits)
    # the gate: selection by the LUT, then the prefix-sum bucket check
    ti = torch.clamp(t_i >> sw.t_shift, 0, sw.t_bins - 1).long()
    ci = torch.clamp(c_i >> sw.c_shift, 0, sw.c_bins - 1).long()
    prob = st["lut"][torch.arange(P, device=ts.device)[:, None], ti, ci]
    selected = rand < prob
    t_ref = torch.where(st["t_last"] == 0, ts[:, 0], st["t_last"]).to(I32)
    burst0 = torch.clamp_max(st["bucket"], lay.bucket_cap).to(I32)
    credit = burst0[:, None] + torch.clamp_min(ts - t_ref[:, None], 0)
    spend = torch.cumsum(torch.where(selected, lay.cost_us, 0).to(I32), -1,
                         dtype=I32)
    granted = selected & (spend <= credit)
    s = dict(st)
    s["rng_key"] = key
    s["bucket"] = torch.clamp(credit[:, -1] - granted.sum(-1, dtype=I32)
                              * lay.cost_us, 0, lay.bucket_cap).to(I32)
    s["t_last"] = ts[:, -1].contiguous()
    s["granted"] = st["granted"] + granted.sum(-1, dtype=I32)
    # F1..F8 from the ring before this batch, then F9 (ipd 0 if new)
    known = (stored != 0) & (stored == h)
    ipd = torch.where(known, torch.clamp_min(
        ts - lanes(tab("last_ts")[g]), 0), 0).to(I32)
    feat = torch.stack([pk["pkt_len"], ipd], dim=-1).reshape(P * n, -1)
    idx = tab("buff_idx")[g].long()
    d = sw.ring_depth
    order = torch.remainder(idx[:, None] + torch.arange(d, device=g.device),
                            d)
    seq = torch.take_along_dim(tab("ring")[g], order[..., None], dim=1)
    payload = torch.cat([seq, feat[:, None]], dim=1)
    # table writes: every lane of a slot writes its slot's last lane
    last = _last_lane(g, P * ls)
    hf, tsf, gf = h.reshape(-1), ts.reshape(-1), granted.reshape(-1)

    def put(k, index, values):
        s[k] = tab(k).index_put(index, values).view(st[k].shape)

    put("hash", (g,), hf[last])
    put("ring", (g, idx), feat[last])
    put("buff_idx", (g,), torch.where(idx + 1 == d, 0, idx + 1).to(I32))
    put("last_ts", (g,), tsf[last])
    added = tab("bklog_n").index_add(0, g, torch.ones_like(tsf))
    g_last = gf[last]
    s["bklog_n"] = added.index_put(
        (g,), torch.where(g_last, 0, added[g])).view(st["bklog_n"].shape)
    put("bklog_t", (g,), torch.where(g_last, tsf[last], tab("bklog_t")[g]))
    s["flow_cnt"] = st["flow_cnt"] + is_new.sum(-1, dtype=I32)
    s["win_pkt_cnt"] = st["win_pkt_cnt"] + n
    cls = lanes(tab("cls")[g])
    out = {"granted": granted, "slot": slot.to(I32), "hash": h,
           "payload": lanes(payload), "verdict": torch.where(cls >= 0, cls,
                                                             -1)}
    return s, out


def control_plane(st: Dict, lay: Layout) -> Dict:
    """T_w rollover of every pipe: LUT from its window counters, counters
    restarted, the window anchored at the pipe's own clock."""
    s = dict(st)
    s["lut"] = rebuilt_lut(st["flow_cnt"], st["win_pkt_cnt"],
                           lay.local_rate, lay.sw)
    s["flow_cnt"] = torch.zeros_like(st["flow_cnt"])
    s["win_pkt_cnt"] = torch.zeros_like(st["win_pkt_cnt"])
    s["win_start"] = st["t_last"].to(I32)
    return s


# -- rings -----------------------------------------------------------------

def _rows(head: torch.Tensor):
    if head.dim() == 0:
        return ()
    return (torch.arange(head.shape[0], device=head.device)[:, None],)


def ring_append(fields: Dict, values: Dict, head, tail, dropped, cap: int,
                valid):
    """Valid lanes appended in lane order; overflow counts as dropped."""
    rank = torch.cumsum(valid.to(I32), -1, dtype=I32)
    fits = valid & (tail[..., None] + rank - head[..., None] <= cap)
    pos = torch.where(fits, torch.remainder(tail[..., None] + rank - 1, cap),
                      cap).long()
    rows, d = _rows(head), head.dim()
    out = {}
    for k, f in fields.items():
        buf = torch.cat([f, f.narrow(d, 0, 1)], dim=d)
        buf[rows + (pos,)] = values[k].to(f.dtype)
        out[k] = buf.narrow(d, 0, cap)
    n_in = fits.sum(-1, dtype=I32)
    return (out, (tail + n_in).to(I32),
            (dropped + valid.sum(-1, dtype=I32) - n_in).to(I32))


def ring_pop(fields: Dict, head, tail, cap: int, budget, lanes: int):
    """min(budget, occupancy, lanes) entries in FIFO order, zero past the
    count: (values, head', count)."""
    take = torch.minimum(torch.minimum(budget.to(I32), tail - head),
                         torch.full_like(head, lanes))
    lane = torch.arange(lanes, dtype=I32, device=head.device)
    live = lane < take[..., None]
    idx = torch.remainder(head[..., None] + lane, cap).long()
    rows = _rows(head)
    vals = {}
    for k, f in fields.items():
        v = f[rows + (idx,)]
        m = live.reshape(live.shape + (1,) * (v.dim() - live.dim()))
        vals[k] = torch.where(m, v, torch.zeros((), dtype=v.dtype,
                                                device=v.device))
    return vals, (head + take).to(I32), take


def step_budget(ts_first, ts_last, rate: float, cap: int) -> torch.Tensor:
    span = torch.clamp_min(ts_last.to(I32) - ts_first.to(I32), 1)
    r = torch.full((), float(np.float32(rate)), dtype=F32,
                   device=span.device)
    return torch.clamp(torch.floor(span.to(F32) * r), 1, cap).to(I32)


def waterfall(occ: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """Split ``budget`` by occupancy: proportional floors, then the rest
    in index order; never more than a consumer's occupancy."""
    occ = torch.clamp_min(occ.to(I32), 0)
    budget = budget.to(I32)
    total = occ.sum(dtype=I32)
    base = torch.minimum(torch.div(budget * occ, torch.clamp_min(total, 1),
                                   rounding_mode="floor").to(I32), occ)
    left = torch.clamp_min(budget - base.sum(dtype=I32), 0)
    room = occ - base
    before = torch.cumsum(room, 0, dtype=I32) - room
    return base + torch.minimum(torch.clamp_min(left - before, 0), room)


_Q = ("id_q_slot", "id_q_hash", "feat_q")
_EQ = ("eq_slot", "eq_hash", "eq_feat", "eq_pipe")
_DL = ("t", "slot", "hash", "cls", "eng")


def dl_push(dline: Dict, t, slots, hashes, cls, count, engines) -> Dict:
    cap = dline["t"].shape[-1]
    n = slots.shape[-1]
    valid = torch.arange(n, dtype=I32, device=slots.device) \
        < count[..., None]
    t = t.to(I32)
    if t.dim() < slots.dim():
        t = t[..., None]
    values = {"t": t.expand(slots.shape), "slot": slots, "hash": hashes,
              "cls": cls, "eng": engines}
    out = dict(dline)
    f, out["tail"], out["dropped"] = ring_append(
        {k: dline[k] for k in _DL}, values, dline["head"], dline["tail"],
        dline["dropped"], cap, valid)
    out.update(f)
    return out


def _write_results(table: Dict, slots, hashes, cls, mask, n_slots: int):
    """Due results into the flow table in lane order: a result lands
    where its slot still holds its hash; the last one of a slot wins."""
    apply = mask & (table["hash"][slots] == hashes)
    skey = torch.where(apply, slots, n_slots)
    order = torch.argsort(skey, stable=True)
    s = skey[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    tgt = torch.where(last & (s < n_slots), s, n_slots)
    buf = torch.cat([table["cls"], table["cls"][:1]])
    buf[tgt] = cls[order].to(I32)
    return buf[:n_slots]


def dl_deliver(st: Dict, dline: Dict, now: torch.Tensor, ls: int):
    """Every queued result due by each pipe's ``now`` into its table."""
    cap = dline["t"].shape[-1]
    P = now.shape[0]
    lane = torch.arange(cap, dtype=I32, device=now.device)
    in_q = lane < (dline["tail"] - dline["head"])[:, None]
    idx = torch.remainder(dline["head"][:, None] + lane, cap).long()
    t, slots, hashes, cls = (torch.take_along_dim(dline[k], idx, dim=-1)
                             for k in ("t", "slot", "hash", "cls"))
    due = in_q & (t <= now.to(I32)[:, None])
    glob = slots.long() + ls * torch.arange(P, device=now.device)[:, None]
    s = dict(st)
    s["cls"] = _write_results(
        {k: st[k].reshape(-1) for k in ("hash", "cls")}, glob.reshape(-1),
        hashes.reshape(-1), cls.reshape(-1), due.reshape(-1),
        P * ls).view(st["cls"].shape)
    out = dict(dline)
    out["head"] = (dline["head"] + due.sum(-1, dtype=I32)).to(I32)
    return s, out


# -- the steps ---------------------------------------------------------------

def _local(carry, chunk, lay: Layout):
    """Delivery, the Data Engine and the enqueue of every pipe."""
    st, q, dline = carry[:3]
    sw = lay.sw
    now = chunk["ts_us"][:, -1]
    st, dline = dl_deliver(st, dline, now, 1 << lay.local_slots_log2)
    st, out = data_engine(st, chunk, lay)
    q = dict(q)
    f, q["tail"], q["dropped"] = ring_append(
        {k: q[k] for k in _Q},
        {"id_q_slot": out["slot"], "id_q_hash": out["hash"],
         "feat_q": out["payload"]}, q["head"], q["tail"], q["dropped"],
        sw.io_queue_len, out["granted"])
    q.update(f)
    aux = {"verdict": out["verdict"], "now": now,
           "ts_first": chunk["ts_us"][:, 0],
           "granted": out["granted"].sum(-1, dtype=I32),
           "classified": (out["verdict"] >= 0).sum(-1, dtype=I32)}
    return st, q, dline, aux


def _freeze(new, old, active):
    def sel(a, b):
        if a is b:
            return b
        return torch.where(active.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    return tuple({k: sel(nd[k], od[k]) for k in od} for nd, od in
                 zip(new, old))


def uniform_step(carry, chunk, cp: bool, active, lay: Layout, model):
    """One lockstep step of P pipes feeding E engines; pipes not
    ``active`` keep their state.  Returns (carry', verdicts [P, B],
    stats [granted, served, classified], served [E], depth [E])."""
    sw, P, E = lay.sw, lay.pipes, lay.engines
    lanes = sw.io_queue_len
    serve = P * lanes
    st, q, dline, aux = _local(carry, chunk, lay)
    st, q, dline = _freeze((st, q, dline), carry[:3], active)
    eq = carry[3]
    i32 = torch.iinfo(I32)
    occ = (q["tail"] - q["head"]) * active.to(I32)
    lo = torch.where(active, aux["ts_first"], i32.max)
    hi = torch.where(active, aux["now"], i32.min).max()
    ebudget = step_budget(lo.min(), hi, lay.engine_rate, P * lanes)
    free = P * lanes - (eq["tail"] - eq["head"])
    shares = waterfall(occ, torch.minimum(E * ebudget, free.sum(dtype=I32)))
    counts = torch.clamp_max(shares, lanes)
    vals, q_head, _ = ring_pop({k: q[k] for k in _Q}, q["head"], q["tail"],
                               lanes, shares, lanes)
    q = dict(q, head=q_head)
    # the router: pipe-major ranks of the dequeued lanes, split across
    # the engines by free ingress space
    intake = waterfall(free, counts.sum(dtype=I32))
    start = torch.cumsum(intake, 0, dtype=I32) - intake
    csum = torch.cumsum(counts.to(I32), 0, dtype=I32)
    rank = start[:, None] + torch.arange(serve, dtype=I32,
                                         device=csum.device)
    pipe = torch.clamp_max(torch.searchsorted(csum, rank, right=True),
                           P - 1)
    lane = rank - (csum - counts)[pipe]
    valid = torch.arange(serve, device=csum.device)[None] < intake[:, None]
    pipe = pipe.to(I32)
    flat = torch.clamp(pipe * lanes + lane, 0, P * lanes - 1).long()
    eq = dict(eq)
    f, eq["tail"], eq["dropped"] = ring_append(
        {k: eq[k] for k in _EQ},
        {"eq_slot": vals["id_q_slot"].reshape(-1)[flat],
         "eq_hash": vals["id_q_hash"].reshape(-1)[flat],
         "eq_feat": vals["feat_q"].reshape((P * lanes,)
                                           + vals["feat_q"].shape[2:])[flat],
         "eq_pipe": pipe}, eq["head"], eq["tail"], eq["dropped"],
        P * lanes, valid)
    eq.update(f)
    ev, e_head, srv = ring_pop({k: eq[k] for k in _EQ}, eq["head"],
                               eq["tail"], P * lanes, ebudget, serve)
    eq["head"] = e_head
    ecls = model.classify(ev["eq_feat"].reshape((E * serve,)
                                                + ev["eq_feat"].shape[2:]))
    ecls = ecls.view(E, serve)
    depth = eq["tail"] - eq["head"]
    # results back through each owning pipe's delay line, engine order
    dev = csum.device
    ok = torch.arange(serve, device=dev)[None, :] < srv[:, None]
    mine = (ok[None] & (ev["eq_pipe"][None]
                        == torch.arange(P, dtype=I32, device=dev)[:, None,
                                                                  None])
            ).reshape(P, E * serve)
    dest = torch.where(mine, torch.cumsum(mine.to(I32), -1, dtype=I32) - 1,
                       E * serve).long()
    eng = torch.arange(E, dtype=I32, device=dev)[:, None].expand(E, serve)
    packed = []
    for v in (ev["eq_slot"], ev["eq_hash"], ecls, eng):
        buf = torch.zeros((P, E * serve + 1), dtype=v.dtype, device=dev)
        buf[(torch.arange(P, device=dev)[:, None], dest)] = \
            v.reshape(-1).expand(P, E * serve)
        packed.append(buf[:, :E * serve])
    my_cnt = mine.sum(-1, dtype=I32)
    now = torch.where(active, aux["now"], hi)
    dline = dl_push(dline, now + sw.loop_latency_us, *packed[:3], my_cnt,
                    packed[3])
    if cp:
        st = control_plane(st, lay)
    a = active.to(I32)
    stats = torch.stack([(aux["granted"] * a).sum(), srv.sum(),
                         (aux["classified"] * a).sum()])
    return (st, q, dline, eq), aux["verdict"], stats, srv, depth


def tail_step(carry, chunk, lay: Layout, model):
    """One pipe's trailing batch (fewer than ``batch`` packets): its ring
    drained against its share of every engine's budget and served
    directly, the lanes tagged with engines by the same waterfall."""
    sw, P, E = lay.sw, lay.pipes, lay.engines
    st, q, dline, aux = _local(carry, chunk, lay)
    eb = step_budget(aux["ts_first"][0], aux["now"][0], lay.engine_rate / P,
                     sw.io_queue_len)
    vals, q_head, cnt = ring_pop({k: q[k][0] for k in _Q}, q["head"][0],
                                 q["tail"][0], sw.io_queue_len, E * eb,
                                 sw.io_queue_len)
    q = dict(q, head=q_head[None])
    assign = waterfall(eb.expand(E), cnt)
    tags = torch.clamp_max(torch.searchsorted(
        torch.cumsum(assign, 0, dtype=I32),
        torch.arange(sw.io_queue_len, dtype=I32, device=cnt.device),
        right=True), E - 1).to(I32)
    cls = model.classify(vals["feat_q"])
    dline = dl_push(dline, aux["now"] + sw.loop_latency_us,
                    vals["id_q_slot"][None], vals["id_q_hash"][None],
                    cls[None], cnt[None], tags[None])
    stats = torch.stack([aux["granted"][0], cnt, aux["classified"][0]])
    return (st, q, dline), aux["verdict"][0], stats, assign


# -- the replay --------------------------------------------------------------

def route(stream: Dict[str, np.ndarray], lay: Layout):
    """Packets to pipes by the high bits of their global slot:
    (order, starts, counts), pipe p's packets in arrival order being
    order[starts[p]:starts[p] + counts[p]]."""
    h = five_tuple_hash({k: torch.from_numpy(np.asarray(stream[k])
                                             .astype(np.int64))
                         for k in PKT_KEYS[:5]}).numpy()
    shift = lay.sw.n_slots_log2 - (lay.pipes.bit_length() - 1)
    pipe = ((h & ((1 << lay.sw.n_slots_log2) - 1)) >> shift).astype(np.int64)
    order = np.argsort(pipe, kind="stable")
    counts = np.bincount(pipe, minlength=lay.pipes).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return order, starts, counts


def _chunk(stream, idx, dev) -> Dict[str, torch.Tensor]:
    out = {}
    for k in PKT_KEYS:
        a = np.asarray(stream[k])[idx]
        dt = np.int32 if k in ("ts_us", "pkt_len") else np.int64
        out[k] = torch.from_numpy(a.astype(dt)).to(dev)
    return out


def replay(stream: Dict[str, np.ndarray], lay: Layout, model, dev
           ) -> Dict:
    """One capture from a fresh state: verdicts [n] in arrival order, the
    stats, and the final carry (state, queues, delay lines, engine
    FIFOs), every tensor on the CPU."""
    B, cpe, P, E = lay.batch, lay.cpe, lay.pipes, lay.engines
    n = len(stream["ts_us"])
    order, starts, counts = route(stream, lay)
    steps_p = counts // B
    n_steps = int(steps_p.max())
    carry = init_carry(lay, dev)
    verd = []
    sums = torch.zeros(3, dtype=I64, device=dev)
    served = torch.zeros(E, dtype=I64, device=dev)
    depths = []
    with torch.no_grad():
        for i in range(n_steps):
            t_idx = np.minimum(i, np.maximum(steps_p - 1, 0))
            idx = order[np.minimum(starts[:, None] + (t_idx * B)[:, None]
                                   + np.arange(B)[None], n - 1)]
            active = torch.from_numpy(i < steps_p).to(dev)
            carry, v, st, srv, depth = uniform_step(
                carry, _chunk(stream, idx, dev), (i + 1) % cpe == 0,
                active, lay, model)
            verd.append(v)
            sums += st
            served += srv
            depths.append(depth)
        tails = {}
        for p in range(P):
            lo, hi = starts[p] + steps_p[p] * B, starts[p] + counts[p]
            if hi <= lo:
                continue
            sel = order[lo:hi]
            one = tuple({k: v[p:p + 1] for k, v in c.items()}
                        for c in carry[:3])
            new, v, st, assign = tail_step(
                one, _chunk(stream, sel[None], dev), lay, model)
            for c, nc in zip(carry[:3], new):
                for k in c:
                    c[k] = torch.cat([c[k][:p], nc[k], c[k][p + 1:]])
            tails[p] = v
            sums += st
            served += assign
        n_batches = n_steps + (1 if tails else 0)
        if tails:
            depths.append(carry[3]["tail"] - carry[3]["head"])
            if n_batches % cpe == 0:
                carry = (control_plane(carry[0], lay),) + carry[1:]
    verdicts = np.full(n, -1, np.int32)
    vd = (torch.stack(verd).cpu().numpy() if verd
          else np.zeros((0, P, B), np.int32))
    for p in range(P):
        seq = [vd[:steps_p[p], p].reshape(-1)]
        if p in tails:
            seq.append(tails[p].cpu().numpy())
        verdicts[order[starts[p]:starts[p] + counts[p]]] = np.concatenate(seq)
    sums = sums.cpu().numpy()
    hist = np.zeros((E, DEPTH_BUCKETS), np.int64)
    if depths:
        d = torch.stack(depths).cpu().numpy().astype(np.int64)
        edges = np.asarray([1 << b for b in range(DEPTH_BUCKETS - 1)])
        for e in range(E):
            b = np.searchsorted(edges, d[:, e], side="right")
            hist[e] = np.bincount(b, minlength=DEPTH_BUCKETS)
    st, q, dline, eq = ({k: v.cpu() for k, v in c.items()} for c in carry)
    stats = {"packets": n, "granted": int(sums[0]),
             "inferences": int(sums[1]), "classified_pkts": int(sums[2]),
             "tree_pkts": 0,
             "dropped_q": int(q["dropped"].sum()),
             "dropped_inflight": int(dline["dropped"].sum()),
             "served_per_engine": [int(x) for x in served.cpu()],
             "dropped_eq": int(eq["dropped"].sum()),
             "engine_q_depth_hist": hist.tolist()}
    return {"verdict": verdicts, "stats": stats,
            "carry": {"state": st, "queues": q, "dl": dline, "eq": eq},
            "batches": n_batches}


def steps_of(stream: Dict[str, np.ndarray], lay: Layout
             ) -> Tuple[int, int]:
    """(lockstep steps, pipes with a tail) of a capture."""
    _, _, counts = route(stream, lay)
    return int((counts // lay.batch).max()), int((counts % lay.batch > 0)
                                                 .sum())


def layout_of(mix: Dict) -> Layout:
    """The Layout a traffic mix's driver settings give."""
    return Layout(Switch(), batch=int(mix["batch_size"]),
                  cpe=int(mix["control_plane_every"]),
                  pipes=int(mix.get("num_pipes", 1)),
                  engines=int(mix.get("num_engines", 1)))
