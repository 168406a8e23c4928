"""Data Engine state: the switch's SRAM tables as tensors.

Port of ``repro/core/data_engine/state.py`` (single pipe): the Flow Info
Table keyed by a truncated 5-tuple hash, the per-flow feature rings, the
token bucket and the windowed statistics (§4.1-4.3), all integers.

Fields that are uint32 in the reference (``hash``, the threefry key
``rng_key``) hold the same values in int64 here: PyTorch's uint32 has
partial op coverage, and int64 masked with ``& 0xFFFFFFFF`` wraps
exactly as uint32 does.  Everything else keeps the reference's int32.

Multi-pipeline layout (``num_pipes`` P, a power of two): a flow's global
slot ``h & (n_slots - 1)`` splits into high bits, the owning pipe
(``pipe_of_hash``), and low bits, the slot inside that pipe's table
(``local_engine_config`` shrinks ``n_slots_log2``).  ``init_pipes_state``
stacks P single-pipe states along a leading dimension, so the stacked
``[P, n_slots / P]`` table, flattened, is the global table indexed by
the global slot: the pipes driver runs every pipe's Data Engine in one
pass over the ``[P * B]`` lanes of a step.  The reference shards that
leading dimension over a device mesh; here it stays a tensor dimension
on one device (there is no counterpart of ``pipe_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.probability import LUTConfig, build_lut, token_rate

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots_log2: int = 12          # flow table size = 2^k
    ring_depth: int = 8             # F1..F8 (§4.3); current pkt is F9
    feat_dim: int = 2               # (pkt_len, inter-packet delay)
    fpga_hz: float = 75e6           # model engine service rate (Fig. 6)
    link_bw_bytes: float = 12.5e9   # 100 Gbps switch<->FPGA channel
    feat_bytes: int = 64            # W: mirrored packet payload
    queue_len: int = 64             # bucket cap <= queue length (§4.2)
    window_us: int = 1_000_000      # T_w statistics window
    lut: LUTConfig = dataclasses.field(default_factory=LUTConfig)
    # fused admission backend: "cuda" (Hopper kernel) | "cuda_prng" (the
    # kernel drawing its own bits) | "ref" (plain PyTorch); None runs the
    # kernel on CUDA tensors, "ref" on CPU ones
    gate_backend: Optional[str] = None
    # use the O(n^2) dense backlog count instead of the sort/segment path
    # (the reference implementation, kept for tests and the throughput
    # bench; bit-identical results)
    dense_backlog: bool = False

    @property
    def n_slots(self) -> int:
        return 1 << self.n_slots_log2

    @property
    def token_rate_per_us(self) -> float:
        return token_rate(self.fpga_hz, self.link_bw_bytes,
                          self.feat_bytes) / 1e6

    @property
    def cost_us(self) -> int:
        """Token cost per grant = 1/V in us (integer, >=1)."""
        return max(1, int(round(1.0 / self.token_rate_per_us)))

    @property
    def bucket_cap_us(self) -> int:
        return self.queue_len * self.cost_us


def init_state(cfg: EngineConfig, n_est: float = 1000.0,
               q_est_pps: float = 1e6, device=None
               ) -> Dict[str, torch.Tensor]:
    """Fresh switch state + a control-plane LUT for (n_est, q_est)."""
    n = cfg.n_slots
    lut = build_lut(n=n_est, q=q_est_pps / 1e6, v=cfg.token_rate_per_us,
                    cfg=cfg.lut)

    def scalar(v):
        return torch.tensor(v, dtype=I32, device=device)

    return {
        # Flow Info Table (§4.1)
        "hash": torch.zeros((n,), dtype=torch.int64, device=device),
        "bklog_n": torch.zeros((n,), dtype=I32, device=device),
        "bklog_t": torch.zeros((n,), dtype=I32, device=device),
        "cls": torch.full((n,), -1, dtype=I32, device=device),
        "buff_idx": torch.zeros((n,), dtype=I32, device=device),
        "pkt_cnt": torch.zeros((n,), dtype=I32, device=device),
        "last_ts": torch.zeros((n,), dtype=I32, device=device),
        # Buffer Manager rings (§4.3)
        "ring": torch.zeros((n, cfg.ring_depth, cfg.feat_dim), dtype=I32,
                            device=device),
        # Rate Limiter (§4.2)
        "bucket": scalar(cfg.bucket_cap_us),
        "t_last": scalar(0),
        "lut": torch.as_tensor(lut, dtype=I32).to(device),
        # windowed statistics (control plane resets each T_w)
        "flow_cnt": scalar(0),
        "win_pkt_cnt": scalar(0),
        "win_start": scalar(0),
        # threefry key of the probabilistic selection
        "rng_key": prng.PRNGKey(0, device=device),
        # telemetry
        "granted": scalar(0),
        "denied_prob": scalar(0),
        "denied_tokens": scalar(0),
        "collisions": scalar(0),
    }


def farm_engine_config(cfg: EngineConfig, num_engines: int) -> EngineConfig:
    """The switch-side view of a farm of ``num_engines`` Model Engines:
    ``cfg`` describes one engine, and the farm's pooled service rate and
    switch<->FPGA channels are E times larger, so the switch's bucket
    (admission) refills E times faster.  ``num_engines=1`` returns a
    config equal to ``cfg``."""
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    return dataclasses.replace(
        cfg, fpga_hz=cfg.fpga_hz * num_engines,
        link_bw_bytes=cfg.link_bw_bytes * num_engines)


def local_engine_config(cfg: EngineConfig, num_pipes: int) -> EngineConfig:
    """One pipeline's view of ``cfg``: ``n_slots / num_pipes`` table
    entries (the low bits of the global slot) and ``1 / num_pipes`` of the
    service rate and the channel.  ``num_pipes=1`` returns a config equal
    to ``cfg``."""
    if num_pipes < 1 or num_pipes & (num_pipes - 1):
        raise ValueError(f"num_pipes must be a power of two, got {num_pipes}")
    p_log2 = num_pipes.bit_length() - 1
    if p_log2 > cfg.n_slots_log2:
        raise ValueError(f"num_pipes={num_pipes} exceeds n_slots="
                         f"{cfg.n_slots}")
    return dataclasses.replace(
        cfg, n_slots_log2=cfg.n_slots_log2 - p_log2,
        fpga_hz=cfg.fpga_hz / num_pipes,
        link_bw_bytes=cfg.link_bw_bytes / num_pipes)


def pipe_of_hash(h, cfg: EngineConfig, num_pipes: int):
    """The owning pipeline of a flow, the high bits of its global slot:
    int32, for a numpy array of hashes or a tensor of them (uint32 values
    held in any integer dtype)."""
    shift = cfg.n_slots_log2 - (num_pipes.bit_length() - 1)
    if isinstance(h, torch.Tensor):
        return ((h & (cfg.n_slots - 1)) >> shift).to(I32)
    gslot = np.asarray(h).astype(np.int64) & (cfg.n_slots - 1)
    return (gslot >> shift).astype(np.int32)


def init_pipes_state(cfg: EngineConfig, num_pipes: int,
                     n_est: float = 1000.0, q_est_pps: float = 1e6,
                     device=None) -> Dict[str, torch.Tensor]:
    """Stacked per-pipe state: every field of ``init_state`` of the local
    config (with 1/P of the flow and packet estimates) gains a leading
    [num_pipes] dimension; pipe p seeds its own key, ``PRNGKey(p)``, so
    pipe 0 of a one-pipe layout is the single-pipe state."""
    lcfg = local_engine_config(cfg, num_pipes)
    one = init_state(lcfg, n_est=n_est / num_pipes,
                     q_est_pps=q_est_pps / num_pipes, device=device)
    stacked = {k: torch.stack([v] * num_pipes) for k, v in one.items()}
    stacked["rng_key"] = torch.stack(
        [prng.PRNGKey(p, device=device) for p in range(num_pipes)])
    return stacked


def hash_five_tuple(src_ip: torch.Tensor, dst_ip: torch.Tensor,
                    src_port: torch.Tensor, dst_port: torch.Tensor,
                    proto: torch.Tensor) -> torch.Tensor:
    """32-bit integer mix of the 5-tuple (stand-in for the switch CRC).

    Inputs hold uint32 values in int64; returns int64 values in
    [1, 2^32), bit-identical to the reference's uint32 hash."""
    m = prng.mul_u32
    h = m(src_ip, 0x9E3779B1)
    h = h ^ m(dst_ip, 0x85EBCA77)
    h = h ^ m(src_port, 0xC2B2AE3D)
    h = h ^ m(dst_port, 0x27D4EB2F)
    h = h ^ m(proto, 0x165667B1)
    h = h ^ (h >> 15)
    h = m(h, 0x2545F491)
    h = h ^ (h >> 13)
    # hash value 0 is reserved for "empty slot"
    return torch.clamp_min(h, 1)


Index = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def get_at(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for a 0-d index tensor.  PyTorch reads a 0-d
    tensor index back to the host (a sync on CUDA); a one-lane
    ``index_select`` does not."""
    return table.index_select(0, index.reshape(1).long())[0]


def set_at(table: torch.Tensor, index: Index, value: torch.Tensor
           ) -> torch.Tensor:
    """``table.at[index].set(value)`` for 0-d index tensors (one, or a
    tuple for the leading dims): a copy with one entry written, with no
    host read."""
    idx = index if isinstance(index, tuple) else (index,)
    return table.index_put(tuple(i.reshape(1).long() for i in idx),
                           value.to(table.dtype).unsqueeze(0))


def make_packets(rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
    """Random packet batch skeleton (tests): numpy arrays, drawn from
    ``rng`` in the reference's order and dtypes, so equal generator
    states give the reference's batch bit for bit."""
    return {
        "src_ip": rng.integers(0, 2**31, n, dtype=np.int64).astype(np.uint32),
        "dst_ip": rng.integers(0, 2**31, n, dtype=np.int64).astype(np.uint32),
        "src_port": rng.integers(0, 65536, n).astype(np.uint32),
        "dst_port": rng.integers(0, 65536, n).astype(np.uint32),
        "proto": rng.integers(6, 18, n).astype(np.uint32),
        "ts_us": np.sort(rng.integers(0, 1_000_000, n)).astype(np.int32),
        "pkt_len": rng.integers(40, 1500, n).astype(np.int32),
    }
