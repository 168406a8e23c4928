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

  With oracle payloads (``oracle_windows=``, a flow's true feature
  sequence each) every packet's ring window comes from
  ``synthetic_traffic.oracle_payloads``, staged beside the packed chunks
  and copied into a second fixed input buffer before each replay; the
  step enqueues it in place of the flow table's ring.

  A capture path or a ``trace_ingest.TraceSpec`` streams (when the system
  has no oracle; with one, it is loaded whole, as the reference does):
  blocks of ``control_plane_every x 4`` full chunks are parsed and
  staged while the graphs replay the block before (``TraceSpec.overlap``:
  a producer thread and a queue of two blocks; otherwise in line), and
  the ragged tail runs eagerly.  A block goes to the card through a
  pinned host buffer, copied with ``non_blocking=True`` on the
  producer's own copy stream; the compute stream waits on the copy's
  event, so the host never waits for the card inside the loop (see
  ``_Stager`` for the waits the producer makes).  Each full chunk
  replays the chunk graphs the system already holds.
* **host** (``driver="host"``; ``exact=True`` for the per-packet scan
  admission): the batch-at-a-time ``step`` loop with a Python list of
  in-flight results and the control plane called from the host each
  window — the oracle the device driver is held against.  It reads each
  batch's grants, slots, hashes and payloads back by design; its tensors
  live on the same device as the device driver's.

* **pipes** (``driver="pipes"``, ``num_pipes`` P, a power of two): the
  Tofino's P ingress pipelines, each on its own slice of the flow table
  (the high bits of a flow's global slot, ``state.pipe_of_hash``), its
  own bucket at 1/P of the rate, its own Vector-I/O ring and delay line,
  all draining into the one Model Engine: its budget split across the
  rings by occupancy (``vio.pipe_shares``).  The reference shards the
  pipes over a device mesh (``pipe_mesh``, ``shard_map``) or, below P
  devices, ``vmap``s them; that vmap is its semantics and this port's
  oracle.  Here the pipes are a leading tensor dimension on one device
  (no mesh): the stacked state [P, ...] runs every pipe's Data Engine in
  one pass over the step's [P * B] lanes, with one fused-gate launch for
  all pipes, and the all-gathers are the stacked tensors themselves.
  ``run_trace`` routes packets to pipes on the host, runs ``max_p
  (count_p // B)`` uniform steps in lockstep (a pipe whose stream ran
  out replays a dummy batch with its state frozen: the masked step), and
  finishes each pipe's tail (< B packets) eagerly through the
  single-pipe step on that pipe's slice, then rolls the window of every
  pipe when the tail round ends one.  The uniform steps run as two CUDA
  graphs on the card (plain and control-plane), both of the masked step:
  with every pipe active it gives exactly the unmasked step's result, so
  the pipes still streaming are a fixed input buffer.  ``num_pipes=1`` is
  the device driver's replay bit for bit.
* **farm** (``driver="farm"``, ``num_engines`` E): E Model Engines behind
  the P pipes (``model_engine/engine_farm.py``): admission at E times one
  engine's rate, the pipes' dequeued lanes routed to the engines' ingress
  FIFOs by free space, each engine on its own budget, verdicts back
  through the owning pipe's delay line tagged with the engine, and
  per-engine served counts and queue-depth samples (kept on the device;
  the histogram is made once, at the end).  ``num_engines=1`` is the
  pipes driver bit for bit.

A capture path or a ``TraceSpec`` is loaded whole on the pipes and farm
drivers, as the reference does: they route globally.

Under the replay telemetry (``repro_torch._telemetry``, off by default)
each driver records its spans (reset, staging, the buffers' load, the
chunk loop, the finish) and counters, and
the device, pipes and farm drivers time each chunk's stages on the card
with probes that the chunk graphs captured with telemetry on hold; those
graphs are kept apart from the ones replayed with telemetry off.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _graph
from repro_torch import _telemetry as tm
from repro_torch._device import (no_host_sync, resolve_device,
                                 resolve_step_backend, validate_backend)
from repro_torch.core.data_engine import engine as de
from repro_torch.core.data_engine import rate_limiter as rl
from repro_torch.core.data_engine.decision_tree import predict
from repro_torch.core.data_engine.state import (EngineConfig,
                                                farm_engine_config,
                                                hash_five_tuple,
                                                init_pipes_state, init_state,
                                                local_engine_config,
                                                pipe_of_hash)
from repro_torch.core.model_engine import delay_line as dl
from repro_torch.core.model_engine import engine_farm as farm
from repro_torch.core.model_engine import serving
from repro_torch.core.model_engine import vector_io as vio
from repro_torch.core.model_engine.inference import EngineModel
from repro_torch.data.synthetic_traffic import oracle_payloads, ring_window
from repro_torch.data.trace_ingest import TraceSpec

I32 = torch.int32

# packet-stream fields consumed by the data plane, with their dtypes on
# the device (the five-tuple is uint32 in the stream: held in int64)
PKT_KEYS = ("src_ip", "dst_ip", "src_port", "dst_port", "proto",
            "ts_us", "pkt_len")
_PKT_DTYPES = {"src_ip": np.int64, "dst_ip": np.int64,
               "src_port": np.int64, "dst_port": np.int64,
               "proto": np.int64, "ts_us": np.int32, "pkt_len": np.int32}

DRIVER_NAMES = ("host", "device", "pipes", "farm")

# the pre-driver= boolean selector cube, kept as a deprecation shim
_LEGACY_KNOBS = ("fast_mode", "device_path", "pipes_path", "farm_path")


@dataclasses.dataclass
class FenixConfig:
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    io: vio.IOConfig = dataclasses.field(default_factory=vio.IOConfig)
    batch_size: int = 512            # packets per data-engine step, per pipe
    loop_latency_us: int = 3         # switch->FPGA->switch (Fig. 11)
    control_plane_every: int = 8     # LUT refresh cadence (batches)
    # "auto" resolves as the reference does: farm if num_engines>1, else
    # pipes if num_pipes>1, else host if exact=True, else device
    driver: str = "auto"
    exact: bool = False
    # switch ingress pipelines sharing the Model Engine(s), each with
    # 1/num_pipes of the slot space and the rate (a power of two); Model
    # Engines behind the switch, admission scaling with the pool
    num_pipes: int = 1
    num_engines: int = 1
    # fused-admission backend for the whole data plane: "cuda" |
    # "cuda_prng" | "ref"; None keeps engine.gate_backend
    gate_backend: Optional[str] = None
    # serving model: "bylen" or an int8_* name (served from model_dir,
    # else the default trained on the synthetic corpus, on the device)
    model: str = "bylen"
    model_dir: Optional[str] = None
    # int8-GEMM backend of the serving model: "cuda" | "ref"
    matmul_backend: Optional[str] = None
    # ---- deprecated spellings (pre-driver= API) ---------------------------
    # None means "not passed".  Any explicit value is mapped onto
    # driver=/exact= in __post_init__ with a single DeprecationWarning per
    # construct, then cleared, as the reference does; new code uses driver=.
    fast_mode: Optional[bool] = None         # deprecated: use exact=
    device_path: Optional[bool] = None       # deprecated: use driver=
    pipes_path: Optional[bool] = None        # deprecated: use driver="pipes"
    farm_path: Optional[bool] = None         # deprecated: use driver="farm"
    # how the device, pipes and farm drivers run their chunk step: "graph"
    # (CUDA graphs, the default on CUDA) | "eager" (the default on the CPU);
    # last, so the reference's fields keep their positions
    step_backend: Optional[str] = None

    def __post_init__(self):
        self._resolve_legacy()
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

    def _resolve_legacy(self) -> None:
        """Map the deprecated booleans onto driver= / exact= as the
        reference's shim does (its warning and errors), then clear
        them."""
        legacy = {k: getattr(self, k) for k in _LEGACY_KNOBS
                  if getattr(self, k) is not None}
        if not legacy:
            return
        if self.driver != "auto":
            raise ValueError(
                "pass either driver= or the deprecated "
                f"{sorted(legacy)} booleans, not both")
        warnings.warn(
            "FenixConfig(" + ", ".join(f"{k}={v}" for k, v in
                                       sorted(legacy.items()))
            + ") is deprecated; use FenixConfig(driver="
              "\"auto\"|\"host\"|\"device\"|\"pipes\"|\"farm\") "
              "(and exact=True for the per-packet scan-admission "
              "host loop)", DeprecationWarning, stacklevel=4)
        fm = legacy.get("fast_mode", True)
        dp = legacy.get("device_path", True)
        use_farm = (self.farm_path if self.farm_path is not None
                    else self.num_engines > 1)
        use_pipes = (self.pipes_path if self.pipes_path is not None
                     else self.num_pipes > 1) or use_farm
        if use_pipes and not (fm and dp):
            raise ValueError(
                "the sharded drivers run the vectorized device scan "
                "only: FenixConfig(driver=\"pipes\"|\"farm\") cannot "
                "be combined with the deprecated fast_mode or device_path "
                "set to False")
        if use_farm:
            self.driver = "farm"
        elif use_pipes:
            self.driver = "pipes"
        elif fm and dp:
            self.driver = "device"
        else:
            self.driver = "host"
            self.exact = self.exact or not fm
        for k in _LEGACY_KNOBS:
            setattr(self, k, None)


def _tree_fill(verdict: torch.Tensor, pkt_len: torch.Tensor, tree: Dict,
               depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packets of unclassified flows take the switch tree's class on
    (pkt_len, 0): returns (verdict', packets the tree answered)."""
    feats_now = torch.stack([pkt_len.to(I32), torch.zeros_like(pkt_len,
                                                               dtype=I32)],
                            dim=-1)
    pre = predict(tree, feats_now, depth)
    return torch.where(verdict >= 0, verdict, pre), (verdict < 0)


def _make_pipe_local(ecfg: EngineConfig, iocfg: vio.IOConfig,
                     tree: Optional[Dict], depth: int):
    """The pipe-local stage of a step: delay-line delivery, the Data
    Engine, enqueue and the switch-tree fill, on one pipe's carry and
    chunk ([B] lanes) or on a stack of pipes' ([P, B] lanes: every pipe
    in one pass, ``de.process_pipes_fast``).  Returns (state, queues,
    dline, aux): aux holds the verdicts, the batch's first and last
    timestamps and the granted / classified / tree counts, a pipe's
    each."""

    def de_local(state, queues, dline, chunk):
        ts = chunk["ts_us"]
        now = ts[..., -1]
        state, dline = dl.deliver(state, dline, now, ecfg.n_slots)
        tm.mark("deliver", ts)
        fast = (de.process_pipes_fast if ts.dim() == 2
                else de.process_batch_fast)
        state, out = fast(state, chunk, ecfg)
        # oracle payloads, when the chunk carries them, replace the ring's
        payload = chunk.get("payload", out["payload"])
        queues = vio.enqueue_device(queues, iocfg, out["granted"],
                                    out["slot"], out["hash"], payload)
        verdict = out["verdict"]
        n_tree = torch.zeros(ts.shape[:-1], dtype=I32, device=ts.device)
        if tree is not None:
            verdict, by_tree = _tree_fill(verdict, chunk["pkt_len"], tree,
                                          depth)
            n_tree = by_tree.sum(-1, dtype=I32)
        aux = {"verdict": verdict, "now": now, "ts_first": ts[..., 0],
               "granted": out["granted"].sum(-1, dtype=I32),
               "classified": (verdict >= 0).sum(-1, dtype=I32),
               "n_tree": n_tree}
        tm.mark("enqueue_ring", ts)
        return state, queues, dline, aux

    return de_local


def _make_single_step(ecfg: EngineConfig, iocfg: vio.IOConfig,
                      loop_latency_us: int, model, tree: Optional[Dict],
                      depth: int):
    """One chunk of the single-pipe device driver: the pipe-local stage,
    the full-budget service epilogue (dequeue, inference, delay-line
    push) and, when ``cp``, the control-plane rebuild — where the host
    oracle applies it, between batches.  With a pipe's local config it is
    also the pipes driver's tail step."""
    de_local = _make_pipe_local(ecfg, iocfg, tree, depth)

    def step_fn(carry, chunk: Dict[str, torch.Tensor], cp: bool):
        state, queues, dline, aux = de_local(*carry, chunk)
        budget = vio.step_budget(aux["ts_first"], aux["now"],
                                 ecfg.token_rate_per_us, iocfg.queue_len)
        queues, s2, h2, f2, cnt = vio.dequeue_device(queues, iocfg, budget)
        tm.mark("dequeue", cnt)
        cls = model.infer(f2)
        tm.mark("infer", cnt)
        dline = dl.push(dline, aux["now"] + loop_latency_us, s2, h2, cls,
                        cnt)
        tm.mark("push", cnt)
        if cp:
            state = rl.control_plane_update(state, ecfg)
            tm.mark("control_plane", cnt)
        stats = torch.stack([aux["granted"], cnt, aux["classified"],
                             aux["n_tree"]])
        return (state, queues, dline), aux["verdict"], stats

    return step_fn


def _make_pipes_step(cfg: "FenixConfig", lcfg: EngineConfig, model,
                     tree: Optional[Dict], depth: int):
    """One step of the pipes driver: P Data Engines feeding the one Model
    Engine.  ``step_fn(carry, chunk, cp, active=None)`` on the stacked
    carry (state, queues, dline) and a chunk of [P, B] lanes: the
    pipe-local stage of every pipe, then the merge — the Model Engine's
    budget over the union of the pipes' time spans (the global rate,
    capped at the pipes' total ring space), split across the rings by
    occupancy — each pipe's dequeue, one inference pass over every
    pipe's lanes, each pipe's results into its own delay line, and, when
    ``cp``, every pipe's T_w rebuild (frozen ones too, as the host oracle
    rolls every window).  ``active`` [P] bool: a pipe not active replays
    a dummy batch with its state frozen, merge weight 0 and its stats
    dropped (None: every pipe active, the unmasked step).  Returns
    (carry', verdicts [P, B], stats [4] summed over the pipes)."""
    iocfg, pipes = cfg.io, cfg.num_pipes
    de_local = _make_pipe_local(lcfg, iocfg, tree, depth)

    def step_fn(carry, chunk: Dict[str, torch.Tensor], cp: bool,
                active: Optional[torch.Tensor] = None):
        (state, queues, dline), occ, lo, hi, aux = farm.merge_view(
            de_local(*carry, chunk), carry, active)
        budget = vio.step_budget(lo.min(), hi.max(),
                                 cfg.engine.token_rate_per_us,
                                 pipes * iocfg.queue_len)
        shares = vio.pipe_shares(occ, budget)
        queues, s2, h2, f2, cnt = vio.dequeue_pipes(queues, iocfg, shares)
        tm.mark("dequeue", cnt)
        cls = model.infer_engines(f2)
        tm.mark("infer", cnt)
        dline = dl.push_pipes(dline, aux["now"] + cfg.loop_latency_us, s2,
                              h2, cls, cnt)
        tm.mark("push", cnt)
        if cp:
            state = rl.control_plane_update_pipes(state, lcfg)
            tm.mark("control_plane", cnt)
        stats = torch.stack([aux["granted"], cnt, aux["classified"],
                             aux["n_tree"]])
        if active is not None:
            stats = stats * active.to(I32)
        return (state, queues, dline), aux["verdict"], stats.sum(-1)

    return step_fn


# the packed chunk: one int64 row per field of PKT_KEYS; these two are
# int32 on the data plane
_I32_KEYS = ("ts_us", "pkt_len")


def _unpack(packed: torch.Tensor, payload: Optional[torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """[len(PKT_KEYS), n] int64 (and the chunk's oracle payloads [n, win,
    dim] int32, or None) -> the chunk dict the step takes."""
    chunk = {k: packed[j].to(I32) if k in _I32_KEYS else packed[j]
             for j, k in enumerate(PKT_KEYS)}
    if payload is not None:
        chunk["payload"] = payload
    return chunk


def _pack(stream: Dict[str, np.ndarray], lo: int, hi: int, out=None
          ) -> np.ndarray:
    """Packets [lo, hi) of ``stream`` as the packed chunks' rows [F, hi -
    lo] int64 (F = len(PKT_KEYS)), written into ``out`` when given."""
    if out is None:
        out = np.empty((len(PKT_KEYS), hi - lo), np.int64)
    for j, k in enumerate(PKT_KEYS):
        out[j] = np.asarray(stream[k][lo:hi]).astype(_PKT_DTYPES[k])
    return out


def _pack_block(stream: Dict[str, np.ndarray], steps: int, batch: int,
                out: np.ndarray) -> np.ndarray:
    """The first ``steps`` full chunks of ``stream`` as packed chunks
    [steps, F, batch] int64, written into ``out``: a chunk is one
    contiguous block."""
    for j, k in enumerate(PKT_KEYS):
        out[:, j, :] = np.asarray(stream[k][:steps * batch]).astype(
            _PKT_DTYPES[k]).reshape(steps, batch)
    return out


# the buffers a chunk step's warm-up before capture must not advance
# (those a system's step has)
_CARRY_SCRATCH = ("state", "queues", "dl", "eq", "stats", "served")


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
    verdicts; ``payload`` (oracle payloads) replaces the ring's."""

    def chunk_step(bufs, packed: torch.Tensor, cp: bool,
                   payload: Optional[torch.Tensor] = None) -> torch.Tensor:
        carry = (bufs["state"], bufs["queues"], bufs["dl"])
        new, verdict, stats = step_fn(carry, _unpack(packed, payload), cp)
        _store(carry, new)
        bufs["stats"] += stats
        tm.mark("store", stats)
        return verdict

    return chunk_step


def _make_pipes_chunk_step(step_fn, with_engines: bool):
    """The in-place step of the pipes and farm drivers, run eagerly and
    captured as a graph alike: ``chunk_step(bufs, packed, cp, payload)``
    runs ``step_fn`` on the stacked carry held in ``bufs`` (``"state"``,
    ``"queues"``, ``"dl"``, and the farm's ``"eq"``) and a packed chunk
    [F, P, B], masked by the pipes still streaming (``bufs["active"]``),
    leaves the new carry in the same tensors, adds the stats (and the
    farm's served counts, ``"served"``) into their sums, writes the
    farm's queue depths to ``bufs["depth"]`` and returns the verdicts
    [P, B]."""
    names = ("state", "queues", "dl") + (("eq",) if with_engines else ())

    def chunk_step(bufs, packed: torch.Tensor, cp: bool,
                   payload: Optional[torch.Tensor] = None) -> torch.Tensor:
        carry = tuple(bufs[k] for k in names)
        new, verdict, stats, *engines = step_fn(
            carry, _unpack(packed, payload), cp, bufs["active"])
        _store(carry, new)
        bufs["stats"] += stats
        if engines:
            bufs["served"] += engines[0]
            bufs["depth"].copy_(engines[1])
        tm.mark("store", stats)
        return verdict

    return chunk_step


class _Stager:
    """Moves the packed blocks of a streamed trace to the device.

    On CUDA a block goes through one of ``slots`` pinned host buffers
    into the device buffer of the same slot, copied with
    ``non_blocking=True`` on the stager's own copy stream, made current
    in whichever thread stages (the current stream is per thread: without
    it the copies would queue on the default stream behind the replays).
    The consumer makes the compute stream wait on ``copied[slot]``
    (``ready``: a device-side wait, none on the host) and records
    ``consumed[slot]`` once the block's replays are enqueued (``done``).

    Before it refills a slot the stager waits on the host until the
    slot's last copy has finished (its pinned buffer is then free to
    overwrite; the one host wait of a streamed replay, made by the
    producer, never by the loop that enqueues the replays), and its copy
    stream waits on the device for ``consumed[slot]`` (the device buffer
    is then free).  The producer stages at most ``queue + 1`` blocks
    ahead of the one the consumer holds, so with ``slots = queue + 2`` a
    slot's ``consumed`` event is always recorded before the slot comes
    round again.  On the CPU ``stage`` returns the block itself."""

    def __init__(self, device: torch.device, shape: Tuple[int, ...],
                 slots: int):
        self.device = device
        self.slots = slots
        self.k = 0
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.host = [torch.empty(shape, dtype=torch.int64,
                                     pin_memory=True) for _ in range(slots)]
            self.dev = [torch.empty(shape, dtype=torch.int64, device=device)
                        for _ in range(slots)]
            self.copied = [torch.cuda.Event() for _ in range(slots)]
            self.consumed = [torch.cuda.Event() for _ in range(slots)]

    def stage(self, shape: Tuple[int, ...], fill) -> Tuple[torch.Tensor,
                                                           int]:
        """``fill(array)`` writes a block of ``shape`` (int64) into the
        next slot's host buffer; returns (the block on the device, its
        slot; -1 on the CPU)."""
        if self.device.type != "cuda":
            arr = np.empty(shape, np.int64)
            fill(arr)
            return torch.from_numpy(arr), -1
        s = self.k % self.slots
        self.k += 1
        while not self.copied[s].query():   # host wait: the slot's last copy
            time.sleep(5e-5)
        n = int(np.prod(shape))
        host = self.host[s].view(-1)[:n].view(shape)
        fill(host.numpy())
        dev = self.dev[s].view(-1)[:n].view(shape)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self.consumed[s])
            dev.copy_(host, non_blocking=True)
            self.copied[s].record(self.stream)
        return dev, s

    def ready(self, slot: int) -> None:
        """The current stream waits for ``slot``'s copy (on the device)."""
        if slot >= 0:
            torch.cuda.current_stream(self.device).wait_event(
                self.copied[slot])

    def done(self, slot: int) -> None:
        """Every use of ``slot``'s device block is enqueued."""
        if slot >= 0:
            self.consumed[slot].record(
                torch.cuda.current_stream(self.device))


class FenixSystem:
    """Stateful co-simulation wrapper (host, device, pipes or farm
    driver: ``cfg.driver``).

    ``device``: where the run's tensors live; ``None`` means ``cuda`` and
    raises on a host without it.  ``model``: a serving model object
    (``EngineModel`` or ``ByLenModel``); ``None`` builds ``cfg.model``.
    ``tree``: switch decision-tree arrays (``decision_tree.tree_arrays``)
    for packets of flows without a verdict, walked ``tree_depth`` levels.
    ``oracle_windows``: each flow's true [n_f, feat_dim] feature sequence
    (by ``flow_idx``); in fast mode a stream that carries ``flow_idx`` /
    ``flow_pos`` then enqueues the oracle's ring windows instead of the
    flow table's.
    """

    def __init__(self, cfg: FenixConfig, model=None,
                 tree: Optional[Dict] = None, tree_depth: int = 4,
                 oracle_windows=None, n_est: float = 1000.0,
                 q_est_pps: float = 1e6, *, device=None):
        self.device = resolve_device(device)
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
        self.oracle = oracle_windows
        self.n_est = n_est
        self.q_est_pps = q_est_pps
        self.step_backend = resolve_step_backend(cfg.step_backend,
                                                 self.device)
        # the farm rides on the pipes driver's layout; the switch sees the
        # engine pool's admission (E x one engine), each pipe 1/P of it
        self._use_farm = cfg.driver == "farm"
        self._use_pipes = cfg.driver in ("pipes", "farm")
        self.gcfg = farm_engine_config(cfg.engine, cfg.num_engines)
        self.lcfg = local_engine_config(self.gcfg, cfg.num_pipes)
        if self._use_pipes:
            self._chunk_step, self._tail_step = self._pipes_steps()
        else:
            self._chunk_step = _make_chunk_step(_make_single_step(
                cfg.engine, cfg.io, cfg.loop_latency_us, model, self.tree,
                tree_depth))
        # the device (or pipes / farm) driver's carry, chunk and verdict
        # buffers (allocated at its first run), its chunk graphs by the cp
        # flag (those captured with telemetry on, whose probes time the
        # step's stages, apart), whether they read the oracle-payload
        # buffer, and their memory pool; the streaming driver's stager;
        # capture seconds of the last run_trace
        self._bufs: Optional[Dict] = None
        self._graphs: Dict[bool, _graph.Graph] = {}
        self._traced_graphs: Dict[bool, _graph.Graph] = {}
        self._graphs_payload = False
        self._pool = None
        self._stager: Optional[_Stager] = None
        self.capture_s = 0.0
        self._reset()

    def _pipes_steps(self):
        """(the in-place uniform step, the tail step) of the pipes or farm
        driver.  The tail step ``tail(carry, chunk)`` runs one pipe's
        trailing batch on that pipe's carry: (carry', verdicts, stats,
        lanes per engine or None)."""
        cfg, lcfg = self.cfg, self.lcfg
        if not self._use_farm:
            step = _make_pipes_step(cfg, lcfg, self.model, self.tree,
                                    self.tree_depth)
            single = _make_single_step(lcfg, cfg.io, cfg.loop_latency_us,
                                       self.model, self.tree,
                                       self.tree_depth)

            def tail(carry, chunk):
                return (*single(carry, chunk, False), None)

            return _make_pipes_chunk_step(step, False), tail
        # each engine's budget is one engine's rate; their sum is the
        # pooled admission rate of gcfg / lcfg
        de_local = _make_pipe_local(lcfg, cfg.io, self.tree,
                                    self.tree_depth)
        args = (cfg.num_pipes, cfg.num_engines, cfg.io,
                cfg.engine.token_rate_per_us, cfg.loop_latency_us, de_local,
                self.model)
        return (_make_pipes_chunk_step(farm.make_farm_step(*args, lcfg),
                                       True),
                farm.make_farm_tail(*args))

    def reset(self) -> None:
        """Fresh run state (tables, queues, delay line, stats)."""
        with tm.span("reset", self.device):
            self._reset()

    def _reset(self) -> None:
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
                      "engine_q_depth_hist": [[0] * farm.DEPTH_BUCKETS
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
        if self._use_pipes:
            # stacked [num_pipes, ...] switch state, FIFOs and delay lines
            # (a pipe's line holds up to E engines' results a step)
            self.pstate = init_pipes_state(self.gcfg, cfg.num_pipes,
                                           n_est=self.n_est,
                                           q_est_pps=self.q_est_pps,
                                           device=self.device)
            self.pqueues = vio.init_pipes_queues(cfg.io, cfg.num_pipes,
                                                 device=self.device)
            self.pdl = dl.init_pipes(cfg.io.queue_len * cfg.num_engines,
                                     cfg.num_pipes, device=self.device)
        if self._use_farm:
            # the engines' ingress FIFOs, on the FPGA side of the link
            self.eq = vio.init_engine_queues(cfg.io, cfg.num_engines,
                                             cfg.num_pipes,
                                             device=self.device)

    # -- one simulation step (host driver) ---------------------------------
    def step(self, packets: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Process one packet batch; returns per-packet verdicts + masks
        (numpy: verdict int32, granted bool, slot int32)."""
        cfg = self.cfg
        if self._use_pipes:
            raise RuntimeError(
                "step() drives the single-pipe host state, which the pipes "
                "and farm drivers do not keep; use run_trace() with "
                "driver=\"pipes\" / driver=\"farm\"")
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
        feats = out["payload"].cpu().numpy()[granted]
        if not cfg.exact and self.oracle is not None and \
                "flow_idx" in packets:
            fi = packets["flow_idx"][granted]
            fp = packets["flow_pos"][granted]
            win = feats.shape[1]
            feats = np.stack([
                ring_window(self.oracle[int(a)], int(b), win)
                for a, b in zip(fi, fp)]) if len(fi) else feats
        self.queues = vio.enqueue_batch(
            self.queues, cfg.io, slot[granted],
            out["hash"].cpu().numpy()[granted], feats)
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

    def control_plane_pipes(self) -> None:
        """The T_w rollover of every pipe, driven from the host: each
        pipe's LUT from its own window counters, anchored at its own
        clock (one host round trip in ``host_syncs``).  The pipes and farm
        drivers roll their windows in the loop without it."""
        self.host_syncs += 1
        self.pstate = rl.control_plane_update_pipes(self.pstate, self.lcfg)

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
    def run_trace(self, trace=None, *, stream=None, source=None,
                  adapter=None, limit: Optional[int] = None,
                  **legacy) -> Dict[str, np.ndarray]:
        """Replay a trace on the configured driver; returns {"verdict": [n]
        int32} in arrival order.

        ``trace`` is a packet-stream dict (``synthetic_traffic.
        packet_stream`` or ``trace_ingest.load_stream`` layout), a capture
        path (pcap or CSV, ingested with default settings) or a
        ``trace_ingest.TraceSpec`` with its adapter / labels / limit /
        chunking / overlap options.  On the device driver a path or a
        TraceSpec streams (module docstring) unless the system has oracle
        payloads; the host, pipes and farm drivers load it whole.
        The keywords ``stream``, ``source``, ``adapter`` and ``limit``,
        and in ``legacy`` the reference's ``trace_labels`` and
        ``labels_by_flow``, are deprecated spellings of the same (a
        ``DeprecationWarning``), as in the reference; any other keyword
        raises ``TypeError``."""
        unknown = sorted(set(legacy) - {"trace_labels", "labels_by_flow"})
        if unknown:
            raise TypeError("run_trace() got an unexpected keyword "
                            f"argument {unknown[0]!r}")
        trace = self._resolve_trace(trace, stream,
                                    legacy.get("labels_by_flow"), source,
                                    adapter,
                                    legacy.get("trace_labels", "auto"),
                                    limit)
        if isinstance(trace, TraceSpec) and self.cfg.driver == "device" \
                and self.oracle is None:
            with tm.replay(self.device, "stream"):
                return self._run_trace_device_stream(trace)
        with tm.replay(self.device, self.cfg.driver):
            stream = trace if isinstance(trace, dict) else trace.load()
            if self._use_pipes:
                return self._run_trace_pipes(stream)
            if self.cfg.driver == "host":
                return self._run_trace_host(stream)
            return self._run_trace_device(stream)

    @staticmethod
    def _resolve_trace(trace, stream, labels_by_flow, source, adapter,
                       trace_labels, limit):
        """Map run_trace's argument surface onto one dict-or-TraceSpec."""
        used = [name for name, passed in
                (("stream", stream is not None),
                 ("source", source is not None),
                 ("adapter", adapter is not None),
                 ("trace_labels", trace_labels != "auto"),
                 ("limit", limit is not None),
                 ("labels_by_flow", labels_by_flow is not None)) if passed]
        if used:
            warnings.warn(
                "run_trace(" + "=..., ".join(used) + "=...) is "
                "deprecated; pass run_trace(trace=<packet-stream dict | "
                "capture path | TraceSpec>)", DeprecationWarning,
                stacklevel=3)
        given = [t for t in (trace, stream, source) if t is not None]
        if len(given) != 1:
            raise ValueError(
                "run_trace needs exactly one trace: trace= (a "
                "packet-stream dict, a capture path, or a TraceSpec); "
                "stream=/source= are its deprecated spellings")
        trace = given[0]
        if isinstance(trace, (dict, TraceSpec)):
            return trace
        # a capture path (or open file object), with any deprecated
        # per-call options folded in
        return TraceSpec(trace, adapter=adapter, labels=trace_labels,
                         limit=limit)

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
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The trace on the device, packed: full chunks [n_chunks, F, B]
        int64 (a chunk is one contiguous block) and the ragged tail [F,
        rest] (None without one), F = len(PKT_KEYS); with oracle payloads
        also theirs, [n_chunks, B, win, dim] and [rest, win, dim] int32
        (else None)."""
        B = self.cfg.batch_size
        n = len(stream["ts_us"])
        full = _pack_block(stream, n_chunks, B,
                           np.empty((n_chunks, len(PKT_KEYS), B), np.int64))
        rest = _pack(stream, n_chunks * B, n) if n > n_chunks * B else None
        pay = None
        if self.oracle is not None and "flow_idx" in stream:
            pay = oracle_payloads(self.oracle, stream["flow_idx"],
                                  stream["flow_pos"], self.cfg.io.feat_len)
        dev = self.device
        tm.open_device(dev)
        chunks = torch.from_numpy(full).to(dev)
        tail = None if rest is None else torch.from_numpy(rest).to(dev)
        pay = None if pay is None else torch.from_numpy(pay).to(dev)
        tm.close_device("stage", dev)
        if pay is None:
            return chunks, tail, None, None
        return (chunks, tail,
                pay[:n_chunks * B].view(n_chunks, B, *pay.shape[1:]),
                pay[n_chunks * B:] if tail is not None else None)

    def _load_bufs(self) -> Dict:
        """The device driver's buffers, holding the system's carry: the
        carry tensors are allocated once and copied into at each run; a
        system with oracle payloads also holds a chunk's payload buffer."""
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
            if self.oracle is not None:
                self._bufs["payload"] = torch.zeros(
                    (cfg.batch_size, cfg.io.feat_len, cfg.io.feat_dim),
                    dtype=I32, device=self.device)
        bufs = self._bufs
        for name, src in (("state", self.state), ("queues", self.queues),
                          ("dl", self._dl)):
            for k, t in bufs[name].items():
                t.copy_(src[k])
        bufs["stats"].zero_()
        return bufs

    def _ensure_graphs(self, bufs: Dict, chunk: torch.Tensor,
                       payload: Optional[torch.Tensor], flags,
                       traced: bool = False) -> None:
        """Capture the chunk step for each cp flag in ``flags`` not yet
        captured (the warm-up reads ``chunk`` and ``payload``, on copies
        of the carry and the stats); adds the seconds to ``capture_s``.
        The graphs read the payload buffer when ``payload`` is given.
        They are captured again once the model's or the tree's tensors
        have moved, or when the payload source changes (an oracle
        system's trace without ``flow_idx`` enqueues the ring's).
        ``traced``: the graphs that hold the telemetry's stage probes,
        kept apart from the others (each set is captured once)."""
        with_pay = payload is not None
        both = (self._graphs, self._traced_graphs)
        if with_pay != self._graphs_payload or any(
                g.stale() for gs in both for g in gs.values()):
            for gs in both:
                gs.clear()
            self._pool = None     # a pool outlives no graph of its own
        self._graphs_payload = with_pay
        graphs = self._traced_graphs if traced else self._graphs
        model, tree = self.model, self.tree

        def reads():    # what the step reads, without a cycle to ``self``
            return _graph.tensors_of(model, tree)

        for cp in flags:
            if cp in graphs:
                continue
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            bufs["chunk"].copy_(chunk)
            if with_pay:
                bufs["payload"].copy_(payload)

            def body(b, cp=cp):
                b["verdict"].copy_(self._chunk_step(
                    b, b["chunk"], cp, b["payload"] if with_pay else None))

            # with telemetry on, the step's marks are recorded into the
            # graph
            with tm.capturing():
                graphs[cp] = _graph.capture(
                    body, bufs, self.device, pool=self._pool,
                    scratch=[(k,) for k in _CARRY_SCRATCH if k in bufs],
                    reads=reads)
            tm.count("graph_captures")
            self.capture_s += graphs[cp].seconds

    def _replay(self, bufs: Dict, chunk: torch.Tensor, cp: bool,
                payload: Optional[torch.Tensor], out: torch.Tensor,
                traced: bool = False) -> None:
        """One full chunk on the step backend, its verdicts into ``out``:
        a copy into the chunk (and payload) buffer and a graph launch (of
        the graphs with the telemetry's probes when ``traced``), or the
        step body run eagerly."""
        if self.step_backend == "graph":
            bufs["chunk"].copy_(chunk)
            if payload is not None:
                bufs["payload"].copy_(payload)
            (self._traced_graphs if traced else self._graphs)[cp].replay()
            out.copy_(bufs["verdict"])
        else:
            out.copy_(self._chunk_step(bufs, chunk, cp, payload))

    def _finish(self, bufs: Dict, n: int, n_batches: int,
                parts: List[torch.Tensor]) -> Dict[str, np.ndarray]:
        """End a device run: the carry back into the system (copies, so a
        later replay moves nothing), the stats read once, the verdicts."""
        tm.open_device(self.device)
        self.state, self.queues, self._dl = (
            _graph.clone(bufs[k]) for k in ("state", "queues", "dl"))
        verdict = torch.cat(parts) if parts else None
        tm.close_device("finish", self.device)
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
        if verdict is None:
            return {"verdict": np.full(0, -1, np.int32)}
        return {"verdict": verdict.cpu().numpy().astype(np.int32)}

    def _run_trace_device(self, stream: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        n = len(stream["ts_us"])
        B, cpe = cfg.batch_size, cfg.control_plane_every
        n_chunks = n // B
        n_batches = n_chunks + (1 if n_chunks * B < n else 0)
        dev, traced = self.device, tm.active()
        with tm.span("stage"):
            chunks, tail, pay, pay_tail = self._stage(stream, n_chunks)
        self._sync_inflight_to_device()
        with tm.span("load_bufs", dev):
            bufs = self._load_bufs()
        cps = [(i + 1) % cpe == 0 for i in range(n_chunks)]
        self.capture_s = 0.0
        if self.step_backend == "graph" and n_chunks:
            self._ensure_graphs(bufs, chunks[0],
                                None if pay is None else pay[0],
                                sorted(set(cps)), traced)
        verd = torch.empty((n_chunks, B), dtype=I32, device=dev)
        parts = [verd.reshape(-1)]
        tm.count("chunks", n_chunks)
        with no_host_sync(dev):
            with tm.span("enqueue"):
                for i, cp in enumerate(cps):
                    tm.open_device(dev)
                    self._replay(bufs, chunks[i], cp,
                                 None if pay is None else pay[i], verd[i],
                                 traced)
                    tm.close_device("store", dev)
            if tail is not None:
                tm.count("tail_steps")
                tm.open_device(dev)
                parts.append(self._chunk_step(bufs, tail,
                                              n_batches % cpe == 0,
                                              pay_tail))
                tm.close_device("store", dev)
        with tm.span("finish"):
            out = self._finish(bufs, n, n_batches, parts)
            tm.collect(dev)
        return out

    # -- the pipes and farm drivers ----------------------------------------
    def _route_pipes(self, stream: Dict[str, np.ndarray]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Packet -> owning pipeline, as contiguous per-pipe segments:
        (order, starts, counts), pipe p's packets (in arrival order) being
        ``order[starts[p] : starts[p] + counts[p]]``."""
        num_pipes = self.cfg.num_pipes
        h = hash_five_tuple(*(torch.from_numpy(np.asarray(
            stream[k]).astype(np.int64)) for k in PKT_KEYS[:5])).numpy()
        pipe = pipe_of_hash(h, self.cfg.engine, num_pipes)
        order = np.argsort(pipe, kind="stable")
        counts = np.bincount(pipe, minlength=num_pipes).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        return order, starts, counts

    def _load_pipe_bufs(self) -> Dict:
        """The pipes / farm driver's buffers (allocated at its first run),
        holding the system's stacked carry: state, queues, delay lines
        (and the engines' queues), the stats and served sums, the chunk
        [F, P, B], the pipes still streaming, the verdicts [P, B], the
        engines' queue depths and, with oracle payloads, their buffer."""
        cfg = self.cfg
        pipes, b = cfg.num_pipes, cfg.batch_size
        dev = self.device
        if self._bufs is None:
            bufs = {
                "state": init_pipes_state(self.gcfg, pipes, device=dev),
                "queues": vio.init_pipes_queues(cfg.io, pipes, device=dev),
                "dl": dl.init_pipes(cfg.io.queue_len * cfg.num_engines,
                                    pipes, device=dev),
                "stats": torch.zeros(4, dtype=torch.int64, device=dev),
                "chunk": torch.zeros((len(PKT_KEYS), pipes, b),
                                     dtype=torch.int64, device=dev),
                "active": torch.ones(pipes, dtype=torch.bool, device=dev),
                "verdict": torch.zeros((pipes, b), dtype=I32, device=dev)}
            if self._use_farm:
                bufs["eq"] = vio.init_engine_queues(
                    cfg.io, cfg.num_engines, pipes, device=dev)
                bufs["served"] = torch.zeros(cfg.num_engines,
                                             dtype=torch.int64, device=dev)
                bufs["depth"] = torch.zeros(cfg.num_engines, dtype=I32,
                                            device=dev)
            if self.oracle is not None:
                bufs["payload"] = torch.zeros(
                    (pipes, b, cfg.io.feat_len, cfg.io.feat_dim), dtype=I32,
                    device=dev)
            self._bufs = bufs
        bufs = self._bufs
        held = [("state", self.pstate), ("queues", self.pqueues),
                ("dl", self.pdl)]
        if self._use_farm:
            held.append(("eq", self.eq))
            bufs["served"].zero_()
        for name, src in held:
            for k, t in bufs[name].items():
                t.copy_(src[k])
        bufs["stats"].zero_()
        return bufs

    def _run_trace_pipes(self, stream: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        """The pipes / farm driver (module docstring): route to pipes,
        ``max_p(count_p // B)`` uniform steps in lockstep (masked: pipes
        whose streams ran out replay a dummy batch of their own last full
        one, frozen), each pipe's tail through the tail step on its slice
        of the carry, then the window roll of every pipe if the tail round
        ends a window.  The loop runs under ``no_host_sync``; verdicts,
        stats, served counts and depth samples stay on the device until
        the end."""
        cfg = self.cfg
        pipes, B, cpe = cfg.num_pipes, cfg.batch_size, \
            cfg.control_plane_every
        dev, traced = self.device, tm.active()
        n = len(stream["ts_us"])
        order, starts, counts = self._route_pipes(stream)
        chunks_p = counts // B                                 # [P]
        n_chunks = int(chunks_p.max())
        with tm.span("stage"):
            chunks, active, tails, pay_dev = self._stage_pipes(
                stream, order, starts, counts, n_chunks)
        with tm.span("load_bufs", dev):
            bufs = self._load_pipe_bufs()
        cps = [(i + 1) % cpe == 0 for i in range(n_chunks)]
        self.capture_s = 0.0
        if self.step_backend == "graph" and n_chunks:
            bufs["active"].copy_(active[0])
            self._ensure_graphs(bufs, chunks[0],
                                None if pay_dev is None else pay_dev[0],
                                sorted(set(cps)), traced)
        verd = torch.empty((n_chunks, pipes, B), dtype=I32, device=dev)
        n_batches = n_chunks + (1 if tails else 0)
        depth = (torch.empty((n_batches, cfg.num_engines), dtype=I32,
                             device=dev) if self._use_farm else None)
        tail_verd = {}
        tm.count("chunks", n_chunks)
        with no_host_sync(dev):
            with tm.span("enqueue"):
                for i, cp in enumerate(cps):
                    tm.open_device(dev)
                    bufs["active"].copy_(active[i])
                    self._replay(bufs, chunks[i], cp,
                                 None if pay_dev is None else pay_dev[i],
                                 verd[i], traced)
                    if depth is not None:
                        depth[i].copy_(bufs["depth"])
                    tm.close_device("store", dev)
            for p, (chunk, pay_p) in tails.items():
                tm.count("tail_steps")
                tm.open_device(dev)
                tail_verd[p] = self._run_tail(bufs, p, chunk, pay_p)
                tm.close_device("store", dev)
            if tails:
                # one depth sample for the tail round; the window rolls
                # after ALL tails, not inside the tail step
                tm.open_device(dev)
                if depth is not None:
                    eq = bufs["eq"]
                    depth[n_chunks].copy_(eq["tail"] - eq["head"])
                if n_batches % cpe == 0:
                    carry = (bufs["state"],)
                    _store(carry, (rl.control_plane_update_pipes(
                        bufs["state"], self.lcfg),))
                tm.close_device("control_plane", dev)
        with tm.span("finish"):
            out = self._finish_pipes(bufs, n, n_batches, verd, tail_verd,
                                     depth, order, starts, counts, chunks_p)
            tm.collect(dev)
        return out

    def _stage_pipes(self, stream: Dict[str, np.ndarray], order: np.ndarray,
                     starts: np.ndarray, counts: np.ndarray, n_chunks: int):
        """The routed trace on the device: the lockstep chunks [C, F, P,
        B] int64 (a pipe whose stream ran out repeats its last full
        batch), the pipes still streaming [C, P], each pipe's tail (< B
        packets) by pipe and, with oracle payloads, theirs."""
        cfg, dev = self.cfg, self.device
        pipes, B, n = cfg.num_pipes, cfg.batch_size, len(stream["ts_us"])
        chunks_p = counts // B
        t_idx = np.minimum(np.arange(n_chunks)[None, :],
                           np.maximum(chunks_p[:, None] - 1, 0))   # [P, C]
        idx = order[np.minimum(
            starts[:, None, None] + (t_idx * B)[:, :, None]
            + np.arange(B)[None, None, :], n - 1)]              # [P, C, B]
        idx = np.transpose(idx, (1, 0, 2))                      # [C, P, B]
        active = (np.arange(n_chunks)[None, :]
                  < chunks_p[:, None]).T.copy()                 # [C, P]
        packed = np.empty((n_chunks, len(PKT_KEYS), pipes, B), np.int64)
        for j, k in enumerate(PKT_KEYS):
            packed[:, j] = np.asarray(stream[k]).astype(_PKT_DTYPES[k])[idx]
        pay = None
        if self.oracle is not None and "flow_idx" in stream:
            pay = oracle_payloads(self.oracle, stream["flow_idx"],
                                  stream["flow_pos"], cfg.io.feat_len)
        rests = {}
        for p in range(pipes):
            lo, hi = starts[p] + chunks_p[p] * B, starts[p] + counts[p]
            if hi > lo:
                sel = order[lo:hi]
                rests[p] = (_pack({k: np.asarray(stream[k])[sel]
                                   for k in PKT_KEYS}, 0, hi - lo),
                            None if pay is None else pay[sel])
        tm.open_device(dev)
        active = torch.from_numpy(active).to(dev)
        chunks = torch.from_numpy(packed).to(dev)
        tails = {p: (torch.from_numpy(c).to(dev),
                     None if a is None else torch.from_numpy(a).to(dev))
                 for p, (c, a) in rests.items()}
        pay = None if pay is None else torch.from_numpy(pay[idx]).to(dev)
        tm.close_device("stage", dev)
        return chunks, active, tails, pay

    def _run_tail(self, bufs: Dict, p: int, packed: torch.Tensor,
                  payload: Optional[torch.Tensor]) -> torch.Tensor:
        """Pipe p's tail batch, eagerly, through the tail step on pipe p's
        slice of the carry buffers (written back in place); adds its
        stats (and the farm's lanes per engine) into their sums."""
        carry = tuple({k: v[p] for k, v in bufs[name].items()}
                      for name in ("state", "queues", "dl"))
        new, verdict, stats, assign = self._tail_step(
            carry, _unpack(packed, payload))
        _store(carry, new)
        bufs["stats"] += stats
        if assign is not None:
            bufs["served"] += assign
        tm.mark("store", stats)
        return verdict

    def _finish_pipes(self, bufs: Dict, n: int, n_batches: int,
                      verd: torch.Tensor, tail_verd: Dict[int, torch.Tensor],
                      depth: Optional[torch.Tensor], order: np.ndarray,
                      starts: np.ndarray, counts: np.ndarray,
                      chunks_p: np.ndarray) -> Dict[str, np.ndarray]:
        """End a pipes / farm run: the carry back into the system (copies),
        the device sums and verdicts read once, the verdicts put back in
        arrival order (a frozen pipe's dummy rows dropped), the stats and
        the farm's depth histogram."""
        dev = self.device
        tm.open_device(dev)
        self.pstate, self.pqueues, self.pdl = (
            _graph.clone(bufs[k]) for k in ("state", "queues", "dl"))
        if self._use_farm:
            self.eq = _graph.clone(bufs["eq"])
        tm.close_device("finish", dev)
        stat = bufs["stats"].cpu().numpy()
        vd = verd.cpu().numpy()
        verdicts = np.full(n, -1, np.int32)
        for p in range(self.cfg.num_pipes):
            seq = [vd[:chunks_p[p], p].reshape(-1)]
            if p in tail_verd:
                seq.append(tail_verd[p].cpu().numpy())
            verdicts[order[starts[p]:starts[p] + counts[p]]] = \
                np.concatenate(seq)
        st = self.stats
        st["packets"] += n
        st["granted"] += int(stat[0])
        st["inferences"] += int(stat[1])
        st["classified_pkts"] += int(stat[2])
        st["tree_pkts"] += int(stat[3])
        st["dropped_q"] = int(self.pqueues["dropped"].sum())
        st["dropped_inflight"] = int(self.pdl["dropped"].sum())
        if not self._use_farm:
            st["served_per_engine"][0] += int(stat[1])
            st["engine_q_depth_hist"][0][0] += n_batches
            return {"verdict": verdicts}
        served = bufs["served"].cpu().numpy()
        st["served_per_engine"] = [a + int(b) for a, b in
                                   zip(st["served_per_engine"], served)]
        st["dropped_eq"] = int(self.eq["dropped"].sum())
        if n_batches:
            hist = farm.depth_histogram(depth.cpu().numpy(),
                                        self.cfg.num_engines)
            st["engine_q_depth_hist"] = [
                [a + b for a, b in zip(row, new)] for row, new in
                zip(st["engine_q_depth_hist"], hist)]
        return {"verdict": verdicts}

    # full chunks of a streamed block: control_plane_every x this many
    # windows; and the blocks a producer thread holds staged ahead
    _STAGE_WINDOWS = 4
    _STAGE_QUEUE = 2

    def _run_trace_device_stream(self, spec: TraceSpec
                                 ) -> Dict[str, np.ndarray]:
        """The device driver over a capture that is never resident whole:
        blocks of full chunks are parsed and staged (``_staged_blocks``)
        while the chunk graphs replay the block before; the ragged tail
        runs eagerly.  The host never waits for the card inside the loop
        (it runs under ``no_host_sync``): the compute stream waits on each
        block's copy event, the verdicts stay on the card until the end,
        and the stats are read once there.  A system without chunk graphs
        captures them on the first block, before the producer starts."""
        cfg = self.cfg
        B, cpe = cfg.batch_size, cfg.control_plane_every
        W = cpe * self._STAGE_WINDOWS
        if self._stager is None:
            self._stager = _Stager(self.device, (W, len(PKT_KEYS), B),
                                   self._STAGE_QUEUE + 2)
        stager = self._stager
        self._sync_inflight_to_device()
        bufs = self._load_bufs()
        self.capture_s = 0.0
        parts: List[torch.Tensor] = []
        n = n_batches = 0
        blocks = self._staged_blocks(spec, W)
        try:
            item = next(blocks, None)
            if item is not None and item[0] == "block" \
                    and self.step_backend == "graph":
                stager.ready(item[2])
                self._ensure_graphs(bufs, item[1][0], None, sorted(
                    {(i + 1) % cpe == 0 for i in range(W)}))
            with no_host_sync(self.device):
                while item is not None:
                    kind, block, slot = item
                    stager.ready(slot)
                    if kind == "block":
                        verd = torch.empty((block.shape[0], B), dtype=I32,
                                           device=self.device)
                        for i in range(block.shape[0]):
                            n_batches += 1
                            self._replay(bufs, block[i],
                                         n_batches % cpe == 0, None,
                                         verd[i])
                        parts.append(verd.reshape(-1))
                        n += block.shape[0] * B
                    else:                       # the tail: < B packets
                        n_batches += 1
                        parts.append(self._chunk_step(
                            bufs, block, n_batches % cpe == 0))
                        n += block.shape[1]
                    stager.done(slot)
                    item = next(blocks, None)
        finally:
            blocks.close()
        return self._finish(bufs, n, n_batches, parts)

    def _stage_gen(self, spec: TraceSpec, W: int):
        """Parse the capture chunk-wise and re-batch it into staged
        ("block", [steps <= W, F, B] int64, slot) items plus one final
        ("tail", [F, < B] int64, slot); each is on its way to the device
        (``_Stager.stage``) when yielded."""
        B = self.cfg.batch_size
        F = len(PKT_KEYS)
        stager = self._stager
        pend: Dict[str, List[np.ndarray]] = {k: [] for k in PKT_KEYS}
        pend_n = 0

        def emit(cols, steps):
            dev, slot = stager.stage((steps, F, B), lambda a: _pack_block(
                cols, steps, B, a))
            return "block", dev, slot

        for raw in spec.iter_chunks():
            for k in PKT_KEYS:
                pend[k].append(np.asarray(raw[k]))
            pend_n += len(raw["ts_us"])
            while pend_n >= W * B:
                cols = {k: np.concatenate(pend[k]) for k in PKT_KEYS}
                yield emit(cols, W)
                pend = {k: [cols[k][W * B:]] for k in PKT_KEYS}
                pend_n -= W * B
        if pend_n:
            cols = {k: np.concatenate(pend[k]) for k in PKT_KEYS}
            steps = pend_n // B
            if steps:
                yield emit(cols, steps)
            if pend_n > steps * B:
                dev, slot = stager.stage(
                    (F, pend_n - steps * B),
                    lambda a: _pack(cols, steps * B, pend_n, out=a))
                yield "tail", dev, slot

    def _staged_blocks(self, spec: TraceSpec, W: int
                       ) -> Iterator[Tuple[str, torch.Tensor, int]]:
        """Yield ``_stage_gen`` items: the first staged in line (the
        caller may capture graphs on it before anything else touches the
        card), the rest in line too unless ``spec.overlap``, and then from
        a producer thread through a bounded queue, so block k+1 is parsed
        and staged while the caller replays block k.  The producer's
        exception is raised here, on the consumer's side."""
        gen = self._stage_gen(spec, W)
        first = next(gen, None)
        if first is None:
            return
        yield first
        if not spec.overlap:
            yield from gen
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self._STAGE_QUEUE)
        stop = threading.Event()
        err: List[BaseException] = []

        def produce():
            try:
                for item in gen:
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue_mod.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # raised on the consumer side
                err.append(e)
            finally:
                while not stop.is_set():    # sentinel, unless aborting
                    try:
                        q.put(None, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue

        t = threading.Thread(target=produce, daemon=True,
                             name="fenix-trace-ingest")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]
