"""FENIX token-generation probability model (paper Eq. 2 + Appendix A).

Port of ``repro/core/probability.py``: ``token_rate``, ``LUTConfig``,
the numpy ``build_lut`` (the initial LUT), ``lut_lookup_np`` (the LM
serving gate's lookup) and Appendix A's ``expected_period`` /
``mean_period_over_flows`` (the fairness analysis), plus
``build_lut_torch``, the port of ``probability_jnp`` / ``build_lut_jnp``
used by the in-loop control-plane rebuild.

``build_lut_torch`` runs in eager float32, one op at a time, with every
constant made float32 first, so each ``+ - * /`` rounds exactly as the
reference's float32 ops do.  Do not fuse it (no ``torch.compile``, no
kernel): a fused ``v*t - n`` may become an FMA and round differently,
and the rebuilt LUT must be bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F32 = torch.float32


def token_rate(fpga_hz: float, link_bw_bytes: float, feat_bytes: int
               ) -> float:
    """Eq. 1: V = min(F, B/W)."""
    return min(fpga_hz, link_bw_bytes / max(feat_bytes, 1))


def probability(t: np.ndarray, c: np.ndarray, n: float, q: float,
                v: float) -> np.ndarray:
    """Eq. 2 in float64 numpy, clipped to [0, 1] (control plane)."""
    t = np.asarray(t, dtype=np.float64)
    c = np.maximum(np.asarray(c, dtype=np.float64), 1e-12)
    qt = q * t
    nc = n * c
    denom = qt - nc
    slow = c * (v * t - n) / np.where(np.abs(denom) < 1e-9, np.inf, denom)
    fast = t * (v * c - q) / np.where(np.abs(denom) < 1e-9, np.inf, -denom)
    p = np.where(denom > 1e-9, slow, np.where(denom < -1e-9, fast,
                 (t >= n / v).astype(np.float64)))
    return np.clip(p, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class LUTConfig:
    """Power-of-two binning so the data plane needs only shifts + clips."""
    t_shift: int = 10          # T bin width = 2^t_shift microseconds
    c_shift: int = 0           # C bin width = 2^c_shift packets
    t_bins: int = 64
    c_bins: int = 32
    prob_bits: int = 16        # probabilities quantized to [0, 2^16)


def build_lut(n: float, q: float, v: float,
              cfg: LUTConfig = LUTConfig()) -> np.ndarray:
    """Eq. 2 discretized into a [t_bins, c_bins] int32 LUT (numpy)."""
    ti = (np.arange(cfg.t_bins) + 0.5) * (1 << cfg.t_shift)
    cj = (np.arange(cfg.c_bins) + 0.5) * (1 << cfg.c_shift)
    tt, cc = np.meshgrid(ti, cj, indexing="ij")
    p = probability(tt, cc, n=n, q=q, v=v)
    return np.round(p * ((1 << cfg.prob_bits) - 1)).astype(np.int32)



def lut_lookup_np(lut: np.ndarray, t_us: np.ndarray, c: np.ndarray,
                  cfg: LUTConfig = LUTConfig()) -> np.ndarray:
    """Reference integer-only lookup (what the switch pipeline does)."""
    ti = np.clip(np.asarray(t_us) >> cfg.t_shift, 0, cfg.t_bins - 1)
    cj = np.clip(np.asarray(c) >> cfg.c_shift, 0, cfg.c_bins - 1)
    return lut[ti, cj]

def expected_period(qi: float, n: float, q: float, v: float) -> float:
    """Appendix A Eq. 6: E_i = (Q_i N + Q) / (2 Q_i V)."""
    return (qi * n + q) / (2.0 * qi * v)


def mean_period_over_flows(rates: np.ndarray, n: float, q: float,
                           v: float) -> float:
    """Appendix A Eq. 7-11: the rate-weighted mean period, == N/V."""
    rates = np.asarray(rates, dtype=np.float64)
    return float(np.sum(rates * np.array(
        [expected_period(r, n, q, v) for r in rates])) / q)


def _f32(x, device) -> torch.Tensor:
    # a fill, not a host-to-device copy: safe inside the replay loop
    return torch.full((), float(np.float32(x)), dtype=F32, device=device)


def probability_torch(t: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                      q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Eq. 2 in float32, op for op as ``probability_jnp``; every argument
    is a float32 tensor on one device."""
    dev = t.device
    eps, inf = _f32(1e-9, dev), _f32(np.inf, dev)
    c = torch.maximum(c, _f32(1e-12, dev))
    qt = q * t
    nc = n * c
    denom = qt - nc
    small = torch.abs(denom) < eps
    slow = c * (v * t - n) / torch.where(small, inf, denom)
    fast = t * (v * c - q) / torch.where(small, inf, -denom)
    p = torch.where(denom > eps, slow,
                    torch.where(denom < -eps, fast,
                                (t >= n / v).to(F32)))
    return torch.clamp(p, 0.0, 1.0)


def build_lut_torch(flow_cnt: torch.Tensor, win_pkt_cnt: torch.Tensor,
                    window_us: int, v: float, cfg: LUTConfig = LUTConfig()
                    ) -> torch.Tensor:
    """LUT rebuild from the raw int32 window counters, on their device
    and with no host read: the port of ``build_lut_jnp``.  Counters [P]
    (one a pipe) give LUTs [P, t_bins, c_bins], each pipe's from its own
    counters, element for element as the reference's vmap."""
    dev = flow_cnt.device
    one = _f32(1.0, dev)
    n = torch.maximum(flow_cnt.to(F32), one)[..., None, None]
    q = (torch.maximum(win_pkt_cnt.to(F32), one)
         / _f32(max(float(window_us), 1.0), dev))[..., None, None]
    ti = (torch.arange(cfg.t_bins, dtype=F32, device=dev) + 0.5) \
        * (1 << cfg.t_shift)
    cj = (torch.arange(cfg.c_bins, dtype=F32, device=dev) + 0.5) \
        * (1 << cfg.c_shift)
    tt, cc = torch.meshgrid(ti, cj, indexing="ij")
    p = probability_torch(tt, cc, n, q, _f32(v, dev))
    return torch.round(p * ((1 << cfg.prob_bits) - 1)).to(torch.int32)
