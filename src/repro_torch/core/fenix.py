"""FENIX end-to-end system: switch (Data Engine) + FPGA (Model Engine).

Port of ``repro/core/fenix.py``, single pipe, with its two drivers:

* **device** (``driver="auto"``'s default): each packet chunk goes
  through the delay-line delivery, the Data Engine (flow table, fused
  admission gate, feature rings), the optional switch decision tree, the
  Vector I/O enqueue, the Model-Engine service budget and dequeue, INT8
  inference over the fixed ``serve_lanes`` lanes, the delay-line push
  and, at each T_w boundary, the control-plane LUT rebuild — all as
  tensors on one device.  The reference's ``lax.scan`` becomes a Python
  loop over chunks and its ``"_cp"`` ``lax.cond`` a Python ``if`` on the
  chunk index, which the host knows without asking the device.  Nothing
  inside the loop reads a value back: stats are summed on the device and
  read once at the end, so a replay makes zero host round trips
  (``host_syncs`` stays 0).  On CUDA the loop runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so any operation that
  would synchronise with the host raises instead.

  The reference jits its chunk step once and donates the carry
  (``_ensure_jits``).  Here one in-place step body reads a chunk, leaves
  the new carry (state, queues, delay line) in buffers the system
  allocates once, adds the chunk's stats into a device sum and returns
  its verdicts.  With ``step_backend="graph"`` (the default on CUDA) the
  body is captured as two CUDA graphs at first use (``_graph.capture``:
  one plain chunk, one chunk that ends a T_w window and rebuilds the
  LUT), kept for every later ``run_trace`` (and captured again once the
  model's or the tree's tensors move), and each full chunk is one
  copy in, one graph launch and one copy of its verdicts out; the trace
  is staged on the device once, a chunk per contiguous block.
  ``"eager"`` (the default on the CPU) runs the same body op by op, as
  does the ragged tail chunk on either backend.
* **host** (``driver="host"``; ``exact=True`` for the per-packet scan
  admission): the batch-at-a-time ``step`` loop with a Python list of
  in-flight results and the control plane called from the host each
  window — the oracle the device driver is held against.  It reads each
  batch's grants, slots, hashes and payloads back by design; its tensors
  live on the same device as the device driver's.

The multi-pipe and engine-farm drivers, capture-path and ``TraceSpec``
traces, and oracle payloads (``oracle_windows=``) are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _graph
from repro_torch._device import (no_host_sync, resolve_device,
                                 resolve_step_backend, validate_backend)
from repro_torch.core.data_engine import engine as de
from repro_torch.core.data_engine import rate_limiter as rl
from repro_torch.core.data_engine.decision_tree import predict
from repro_torch.core.data_engine.state import EngineConfig, init_state
from repro_torch.core.model_engine import delay_line as dl
from repro_torch.core.model_engine import serving
from repro_torch.core.model_engine import vector_io as vio
from repro_torch.core.model_engine.inference import EngineModel

I32 = torch.int32

# packet-stream fields consumed by the data plane, with their dtypes on
# the device (the five-tuple is uint32 in the stream: held in int64)
PKT_KEYS = ("src_ip", "dst_ip", "src_port", "dst_port", "proto",
            "ts_us", "pkt_len")
_PKT_DTYPES = {"src_ip": np.int64, "dst_ip": np.int64,
               "src_port": np.int64, "dst_port": np.int64,
               "proto": np.int64, "ts_us": np.int32, "pkt_len": np.int32}

DRIVER_NAMES = ("host", "device", "pipes", "farm")
_NOT_PORTED = {
    "pipes": "the multi-pipe driver is a later slice (ROADMAP.md, "
             "'Modules to port')",
    "farm": "the engine farm is a later slice (ROADMAP.md, 'Modules to "
            "port')",
}
DEPTH_BUCKETS = 16                 # engine-farm queue-depth histogram width


@dataclasses.dataclass
class FenixConfig:
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    io: vio.IOConfig = dataclasses.field(default_factory=vio.IOConfig)
    batch_size: int = 512            # packets per data-engine step
    loop_latency_us: int = 3         # switch->FPGA->switch (Fig. 11)
    control_plane_every: int = 8     # LUT refresh cadence (batches)
    # "auto" resolves as the reference does: farm if num_engines>1, else
    # pipes if num_pipes>1, else host if exact=True, else device.  "host"
    # and "device" are ported.
    driver: str = "auto"
    exact: bool = False
    num_pipes: int = 1
    num_engines: int = 1
    # fused-admission backend for the whole data plane: "cuda" |
    # "cuda_prng" | "ref"; None keeps engine.gate_backend
    gate_backend: Optional[str] = None
    # serving model: "bylen" or an int8_* name (served from model_dir)
    model: str = "bylen"
    model_dir: Optional[str] = None
    # int8-GEMM backend of the serving model: "cuda" | "ref"
    matmul_backend: Optional[str] = None
    # how the device driver runs its chunk step: "graph" (CUDA graphs,
    # the default on CUDA) | "eager" (the default on the CPU)
    step_backend: Optional[str] = None

    def __post_init__(self):
        if self.driver == "auto":
            self.driver = ("farm" if self.num_engines > 1 else
                           "pipes" if self.num_pipes > 1 else
                           "host" if self.exact else "device")
        if self.driver not in DRIVER_NAMES:
            raise ValueError(
                f"unknown driver {self.driver!r}; pick one of "
                f"{('auto',) + DRIVER_NAMES}")
        if self.num_engines > 1 and self.driver != "farm":
            raise ValueError(
                f"num_engines={self.num_engines} needs the engine-farm "
                f"driver, not driver={self.driver!r}")
        if self.num_pipes > 1 and self.driver not in ("pipes", "farm"):
            raise ValueError(
                f"num_pipes={self.num_pipes} needs a sharded driver, not "
                f"driver={self.driver!r}")
        if self.exact and self.driver != "host":
            raise ValueError("exact=True runs only on driver=\"host\"")
        validate_backend(self.gate_backend, "gate_backend")
        validate_backend(self.matmul_backend, "matmul_backend")
        validate_backend(self.step_backend, "step_backend")


def _tree_fill(verdict: torch.Tensor, pkt_len: torch.Tensor, tree: Dict,
               depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packets of unclassified flows take the switch tree's class on
    (pkt_len, 0): returns (verdict', packets the tree answered)."""
    feats_now = torch.stack([pkt_len.to(I32), torch.zeros_like(pkt_len,
                                                               dtype=I32)],
                            dim=-1)
    pre = predict(tree, feats_now, depth)
    return torch.where(verdict >= 0, verdict, pre), (verdict < 0)


def _make_single_step(ecfg: EngineConfig, iocfg: vio.IOConfig,
                      loop_latency_us: int, model, tree: Optional[Dict],
                      depth: int):
    """One chunk of the single-pipe device driver: delivery, the Data
    Engine, the switch-tree fill, enqueue, the full-budget service
    epilogue (dequeue, inference, delay-line push) and, when ``cp``, the
    control-plane rebuild — where the host oracle applies it, between
    batches."""

    def step_fn(carry, chunk: Dict[str, torch.Tensor], cp: bool):
        state, queues, dline = carry
        ts = chunk["ts_us"]
        now = ts[-1]
        state, dline = dl.deliver(state, dline, now, ecfg.n_slots)
        state, out = de.process_batch_fast(state, chunk, ecfg)
        queues = vio.enqueue_device(queues, iocfg, out["granted"],
                                    out["slot"], out["hash"],
                                    out["payload"])
        verdict = out["verdict"]
        n_tree = torch.zeros((), dtype=I32, device=ts.device)
        if tree is not None:
            verdict, by_tree = _tree_fill(verdict, chunk["pkt_len"], tree,
                                          depth)
            n_tree = by_tree.sum(dtype=I32)
        budget = vio.step_budget(ts[0], now, ecfg.token_rate_per_us,
                                 iocfg.queue_len)
        queues, s2, h2, f2, cnt = vio.dequeue_device(queues, iocfg, budget)
        cls = model.infer(f2)
        dline = dl.push(dline, now + loop_latency_us, s2, h2, cls, cnt)
        if cp:
            state = rl.control_plane_update(state, ecfg)
        stats = torch.stack([out["granted"].sum(dtype=I32), cnt,
                             (verdict >= 0).sum(dtype=I32), n_tree])
        return (state, queues, dline), verdict, stats

    return step_fn


# the packed chunk: one int64 row per field of PKT_KEYS; these two are
# int32 on the data plane
_I32_KEYS = ("ts_us", "pkt_len")


def _unpack(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[len(PKT_KEYS), n] int64 -> the chunk dict the step takes."""
    return {k: packed[j].to(I32) if k in _I32_KEYS else packed[j]
            for j, k in enumerate(PKT_KEYS)}


# the buffers a chunk step's warm-up before capture must not advance
_CARRY_SCRATCH = (("state",), ("queues",), ("dl",), ("stats",))


def _store(dst: Tuple[Dict, ...], src: Tuple[Dict, ...]) -> None:
    """Leave the new carry ``src`` in the carry buffers ``dst``: one copy
    a changed leaf.  The step builds every changed leaf anew (from the
    chunk, or out of place from the old carry), so no new leaf is a view
    of a carry buffer and the copies may run in any order."""
    for d, s in zip(dst, src):
        for k, t in d.items():
            if s[k] is not t:
                t.copy_(s[k])


def _make_chunk_step(step_fn):
    """The in-place chunk step of the device driver, the body that is run
    eagerly and captured as a graph alike: ``chunk_step(bufs, packed,
    cp)`` runs ``step_fn`` on the carry held in ``bufs`` (``"state"``,
    ``"queues"``, ``"dl"``), leaves the new carry in the same tensors,
    adds the chunk's stats into ``bufs["stats"]`` and returns its
    verdicts."""

    def chunk_step(bufs, packed: torch.Tensor, cp: bool) -> torch.Tensor:
        carry = (bufs["state"], bufs["queues"], bufs["dl"])
        new, verdict, stats = step_fn(carry, _unpack(packed), cp)
        _store(carry, new)
        bufs["stats"] += stats
        return verdict

    return chunk_step


class FenixSystem:
    """Stateful co-simulation wrapper (single pipe, host or device
    driver).

    ``device``: where the run's tensors live; ``None`` means ``cuda`` and
    raises on a host without it.  ``model``: a serving model object
    (``EngineModel`` or ``ByLenModel``); ``None`` builds ``cfg.model``.
    ``tree``: switch decision-tree arrays (``decision_tree.tree_arrays``)
    for packets of flows without a verdict, walked ``tree_depth`` levels.
    """

    def __init__(self, cfg: FenixConfig, model=None,
                 tree: Optional[Dict] = None, tree_depth: int = 4, *,
                 device=None, oracle_windows=None, n_est: float = 1000.0,
                 q_est_pps: float = 1e6):
        self.device = resolve_device(device)
        if cfg.driver not in ("host", "device"):
            raise NotImplementedError(
                f"driver={cfg.driver!r} is not ported yet: "
                f"{_NOT_PORTED[cfg.driver]}")
        if oracle_windows is not None:
            raise NotImplementedError(
                "oracle_windows= (oracle payloads) is not ported yet "
                "(ROADMAP.md, 'Modules to port')")
        if cfg.gate_backend is not None:
            cfg = dataclasses.replace(
                cfg, engine=dataclasses.replace(
                    cfg.engine, gate_backend=cfg.gate_backend))
        validate_backend(cfg.engine.gate_backend, "gate_backend")
        if model is None:
            model = serving.build_model(cfg.model,
                                        matmul_backend=cfg.matmul_backend,
                                        model_dir=cfg.model_dir,
                                        device=self.device)
        elif cfg.matmul_backend is not None:
            if not isinstance(model, EngineModel):
                raise ValueError(
                    "matmul_backend applies to quantized EngineModels; "
                    f"got {type(model).__name__}")
            model = model.with_backend(cfg.matmul_backend)
        if isinstance(model, EngineModel):
            model = model.to(self.device)
        self.cfg = cfg
        self.model = model
        self.tree = (None if tree is None else
                     {k: v.to(self.device) for k, v in tree.items()})
        self.tree_depth = tree_depth
        self.n_est = n_est
        self.q_est_pps = q_est_pps
        self.step_backend = resolve_step_backend(cfg.step_backend,
                                                 self.device)
        self._chunk_step = _make_chunk_step(_make_single_step(
            cfg.engine, cfg.io, cfg.loop_latency_us, model, self.tree,
            tree_depth))
        # the device driver's carry, chunk and verdict buffers (allocated
        # at its first run), its chunk graphs by the cp flag and their
        # memory pool; capture seconds of the last run_trace
        self._bufs: Optional[Dict] = None
        self._graphs: Dict[bool, _graph.Graph] = {}
        self._pool = None
        self.capture_s = 0.0
        self.reset()

    def reset(self) -> None:
        """Fresh run state (tables, queues, delay line, stats)."""
        cfg = self.cfg
        self.state = init_state(cfg.engine, n_est=self.n_est,
                                q_est_pps=self.q_est_pps,
                                device=self.device)
        self.queues = vio.init_queues(cfg.io, device=self.device)
        self.stats = {"packets": 0, "granted": 0, "inferences": 0,
                      "classified_pkts": 0, "tree_pkts": 0, "dropped_q": 0,
                      "dropped_inflight": 0,
                      "served_per_engine": [0] * cfg.num_engines,
                      "dropped_eq": 0,
                      "engine_q_depth_hist": [[0] * DEPTH_BUCKETS
                                              for _ in
                                              range(cfg.num_engines)]}
        # host-driven control-plane round trips: 0 on the device driver,
        # one per T_w rollover of the host loop
        self.host_syncs = 0
        # in-flight inference results, host view: (deliver_ts, slot, h,
        # cls) — and its twin, the device-resident delay line
        self._inflight: List[Tuple[int, int, int, int]] = []
        self._dl = dl.init(cfg.io.queue_len, device=self.device)
        self._dl_dirty = False

    # -- one simulation step (host driver) ---------------------------------
    def step(self, packets: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Process one packet batch; returns per-packet verdicts + masks
        (numpy: verdict int32, granted bool, slot int32)."""
        cfg = self.cfg
        self._sync_inflight_to_host()
        n = len(packets["ts_us"])
        batch = self._to_device(packets)
        now = int(packets["ts_us"][-1])
        # deliver finished inferences whose latency elapsed
        self._deliver(now)
        if not cfg.exact:
            self.state, out = de.process_batch_fast(self.state, batch,
                                                    cfg.engine)
        else:
            self.state, out = de.process_batch(self.state, batch, cfg.engine,
                                               tree=self.tree,
                                               tree_depth=self.tree_depth)
        granted = out["granted"].cpu().numpy()
        slot = out["slot"].cpu().numpy()
        self.queues = vio.enqueue_batch(
            self.queues, cfg.io, slot[granted],
            out["hash"].cpu().numpy()[granted],
            out["payload"].cpu().numpy()[granted])
        # the Model Engine serves a batch bounded by its service rate V
        # (vio.step_budget, the device driver's own formula)
        budget = int(vio.step_budget(
            torch.tensor(int(packets["ts_us"][0]), dtype=I32),
            torch.tensor(now, dtype=I32), cfg.engine.token_rate_per_us,
            cfg.io.queue_len))
        self.queues, s2, h2, f2 = vio.dequeue_batch(self.queues, cfg.io,
                                                    budget)
        if len(s2):
            cls = self.model.infer(
                torch.from_numpy(f2).to(self.device)).cpu().numpy()
            self._inflight.extend(
                (now + cfg.loop_latency_us, int(a), int(b), int(c))
                for a, b, c in zip(s2, h2, cls))
            self.stats["inferences"] += len(s2)
            self.stats["served_per_engine"][0] += len(s2)
        # verdicts: flow-table class (post-delivery) else switch tree
        verdict = out["verdict"]
        if self.tree is not None and not cfg.exact:
            verdict, by_tree = _tree_fill(verdict, batch["pkt_len"],
                                          self.tree, self.tree_depth)
            self.stats["tree_pkts"] += int(by_tree.sum())
        verdict = verdict.cpu().numpy()
        self.stats["packets"] += n
        self.stats["granted"] += int(granted.sum())
        self.stats["classified_pkts"] += int(np.sum(verdict >= 0))
        self.stats["dropped_q"] = int(self.queues["dropped"])
        # one depth sample per batch round; no engine queues on this path
        self.stats["engine_q_depth_hist"][0][0] += 1
        return {"verdict": verdict, "granted": granted, "slot": slot}

    def _to_device(self, packets: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(
                    np.asarray(packets[k]).astype(_PKT_DTYPES[k])))
                .to(self.device) for k in PKT_KEYS}

    def _deliver(self, now: int) -> None:
        """Write every in-flight result due by ``now`` to the flow table,
        in list order (``dl.write_results``: the last due result of a
        slot that still holds its hash wins)."""
        due = [r for r in self._inflight if r[0] <= now]
        self._inflight = [r for r in self._inflight if r[0] > now]
        if due:
            cols = torch.tensor([r[1:] for r in due], dtype=torch.int64,
                                device=self.device)
            self.state = dl.write_results(
                self.state, cols[:, 0], cols[:, 1], cols[:, 2],
                torch.ones(len(due), dtype=torch.bool, device=self.device),
                self.cfg.engine.n_slots)

    def control_plane(self) -> None:
        """T_w rollover driven from the host loop: LUT refresh from the
        observed (N, Q) window counters + window reset — the same
        ``rl.control_plane_update`` the device driver runs in its loop.
        Each call counts one host round trip in ``host_syncs``."""
        self.host_syncs += 1
        self.state = rl.control_plane_update(self.state, self.cfg.engine)

    # -- in-flight state interop (host list <-> device delay line) ---------
    def _sync_inflight_to_host(self) -> None:
        if self._dl_dirty:
            self._inflight = dl.to_list(self._dl) + self._inflight
            self._dl = dl.init(self.cfg.io.queue_len, device=self.device)
            self._dl_dirty = False

    def _sync_inflight_to_device(self) -> None:
        if self._inflight:
            t, slot, h, cls = (torch.tensor(c, device=self.device)
                               for c in zip(*self._inflight))
            self._dl = dl.push(self._dl, t, slot.to(I32), h, cls.to(I32),
                               torch.tensor(len(self._inflight), dtype=I32,
                                            device=self.device))
        self._inflight = []
        self._dl_dirty = True

    # -- full-trace drivers -------------------------------------------------
    def run_trace(self, trace: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
        """Replay a packet-stream dict (``synthetic_traffic.packet_stream``
        layout) on the configured driver; returns {"verdict": [n] int32}
        in arrival order."""
        if not isinstance(trace, dict):
            raise NotImplementedError(
                "run_trace takes a packet-stream dict; capture paths and "
                "TraceSpec streaming are not ported yet (ROADMAP.md, "
                "'Modules to port')")
        if self.cfg.driver == "host":
            return self._run_trace_host(trace)
        return self._run_trace_device(trace)

    def _run_trace_host(self, stream: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        n = len(stream["ts_us"])
        verdicts = np.full(n, -1, np.int32)
        for i, start in enumerate(range(0, n, cfg.batch_size)):
            sl = slice(start, min(start + cfg.batch_size, n))
            out = self.step({k: v[sl] for k, v in stream.items()})
            verdicts[sl] = out["verdict"]
            if (i + 1) % cfg.control_plane_every == 0:
                self.control_plane()
        return {"verdict": verdicts}

    def _stage(self, stream: Dict[str, np.ndarray], n_chunks: int
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The trace on the device, packed: full chunks [n_chunks, F, B]
        int64 (a chunk is one contiguous block) and the ragged tail [F,
        rest] (None without one), F = len(PKT_KEYS)."""
        B = self.cfg.batch_size
        cols = np.stack([np.asarray(stream[k]).astype(_PKT_DTYPES[k])
                         .astype(np.int64) for k in PKT_KEYS])
        full = cols[:, :n_chunks * B].reshape(len(PKT_KEYS), n_chunks, B)
        chunks = torch.from_numpy(np.ascontiguousarray(
            full.transpose(1, 0, 2))).to(self.device)
        rest = cols[:, n_chunks * B:]
        tail = (torch.from_numpy(np.ascontiguousarray(rest)).to(self.device)
                if rest.shape[1] else None)
        return chunks, tail

    def _load_bufs(self) -> Dict:
        """The device driver's buffers, holding the system's carry: the
        carry tensors are allocated once and copied into at each run."""
        cfg = self.cfg
        if self._bufs is None:
            self._bufs = {
                "state": init_state(cfg.engine, device=self.device),
                "queues": vio.init_queues(cfg.io, device=self.device),
                "dl": dl.init(cfg.io.queue_len, device=self.device),
                "stats": torch.zeros(4, dtype=torch.int64,
                                     device=self.device),
                "chunk": torch.zeros((len(PKT_KEYS), cfg.batch_size),
                                     dtype=torch.int64, device=self.device),
                "verdict": torch.zeros(cfg.batch_size, dtype=I32,
                                       device=self.device)}
        bufs = self._bufs
        for name, src in (("state", self.state), ("queues", self.queues),
                          ("dl", self._dl)):
            for k, t in bufs[name].items():
                t.copy_(src[k])
        bufs["stats"].zero_()
        return bufs

    def _ensure_graphs(self, bufs: Dict, chunks: torch.Tensor,
                       flags) -> None:
        """Capture the chunk step for each cp flag in ``flags`` not yet
        captured (the warm-up reads the trace's first chunk, on copies of
        the carry and the stats); adds the seconds to ``capture_s``.  The
        graphs are captured again once the model's or the tree's tensors
        have moved."""
        if any(g.stale() for g in self._graphs.values()):
            self._graphs.clear()
            self._pool = None     # a pool outlives no graph of its own
        model, tree = self.model, self.tree

        def reads():    # what the step reads, without a cycle to ``self``
            return _graph.tensors_of(model, tree)

        for cp in flags:
            if cp in self._graphs:
                continue
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            bufs["chunk"].copy_(chunks[0])

            def body(b, cp=cp):
                b["verdict"].copy_(self._chunk_step(b, b["chunk"], cp))

            self._graphs[cp] = _graph.capture(
                body, bufs, self.device, pool=self._pool,
                scratch=_CARRY_SCRATCH, reads=reads)
            self.capture_s += self._graphs[cp].seconds

    def _run_trace_device(self, stream: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        n = len(stream["ts_us"])
        B, cpe = cfg.batch_size, cfg.control_plane_every
        n_chunks = n // B
        n_batches = n_chunks + (1 if n_chunks * B < n else 0)
        chunks, tail = self._stage(stream, n_chunks)
        self._sync_inflight_to_device()
        bufs = self._load_bufs()
        cps = [(i + 1) % cpe == 0 for i in range(n_chunks)]
        graphs = self.step_backend == "graph"
        self.capture_s = 0.0
        if graphs:
            self._ensure_graphs(bufs, chunks, sorted(set(cps)))
        verd = torch.empty((n_chunks, B), dtype=I32, device=self.device)
        verd_tail = None
        with no_host_sync(self.device):
            for i, cp in enumerate(cps):
                if graphs:
                    bufs["chunk"].copy_(chunks[i])
                    self._graphs[cp].replay()
                    verd[i].copy_(bufs["verdict"])
                else:
                    verd[i].copy_(self._chunk_step(bufs, chunks[i], cp))
            if tail is not None:
                verd_tail = self._chunk_step(bufs, tail,
                                             n_batches % cpe == 0)
        # the system's own carry: copies, so a later replay moves nothing
        self.state, self.queues, self._dl = (
            _graph.clone(bufs[k]) for k in ("state", "queues", "dl"))
        self._dl_dirty = True
        stat = bufs["stats"].cpu().numpy()
        self.stats["packets"] += n
        self.stats["granted"] += int(stat[0])
        self.stats["inferences"] += int(stat[1])
        self.stats["classified_pkts"] += int(stat[2])
        self.stats["tree_pkts"] += int(stat[3])
        self.stats["dropped_q"] = int(self.queues["dropped"])
        self.stats["dropped_inflight"] = int(self._dl["dropped"])
        self.stats["served_per_engine"][0] += int(stat[1])
        self.stats["engine_q_depth_hist"][0][0] += n_batches
        parts = [verd.reshape(-1)] + ([] if verd_tail is None
                                      else [verd_tail])
        return {"verdict": torch.cat(parts).cpu().numpy().astype(np.int32)}
