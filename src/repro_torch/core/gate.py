"""FENIX Data-Engine admission control generalized to LM serving.

Port of ``repro/core/gate.py``: numpy only, with the reference's own
``default_rng(seed)`` draws, so the same arrivals and seed admit the same
requests.

The paper's core systems insight — a line-rate front-end must rate-match a
slower inference back-end via probabilistic token-bucket admission with the
fairness property E[interval] = N/V — transfers directly to LM serving:

  flows            -> request streams (tenants/sessions)
  packet rate Q_i  -> request rate of stream i
  FPGA rate F      -> decode-step throughput of the serving mesh
  link B/W         -> ICI/PCIe ingress bytes per request

``ServeGate`` admits decode requests with Eq. 2 probabilities so slow
tenants are not starved by fast ones while the backend stays saturated but
un-overloaded — same math, same LUT, same bucket (§4.2 / Appendix A).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.probability import LUTConfig, build_lut, lut_lookup_np


@dataclasses.dataclass
class GateConfig:
    backend_rate: float          # requests/s the serving mesh sustains (F)
    ingress_bw_bytes: float = 50e9
    req_bytes: int = 4096        # W: prompt+metadata bytes per admission
    queue_len: int = 128
    window_s: float = 1.0
    lut: LUTConfig = dataclasses.field(default_factory=LUTConfig)

    @property
    def v_per_us(self) -> float:
        return min(self.backend_rate,
                   self.ingress_bw_bytes / self.req_bytes) / 1e6

    @property
    def cost_us(self) -> int:
        return max(1, int(round(1.0 / self.v_per_us)))


class ServeGate:
    """Per-stream probabilistic token-bucket admission (Alg. 1)."""

    def __init__(self, cfg: GateConfig, seed: int = 0,
                 n_streams_est: float = 16.0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.bucket = cfg.queue_len * cfg.cost_us
        self.t_last = 0
        self.backlog_n: Dict[int, int] = {}
        self.backlog_t: Dict[int, int] = {}
        self.win_reqs = 0
        self.win_streams: set = set()
        self.n_est = n_streams_est
        self.lut_cfg = self._adapt_lut_cfg(n_streams_est)
        self.lut = build_lut(n=n_streams_est,
                             q=cfg.backend_rate / 1e6 * 4,
                             v=cfg.v_per_us, cfg=self.lut_cfg)
        self.admitted = 0
        self.denied = 0

    def _adapt_lut_cfg(self, n: float) -> LUTConfig:
        """T bins must span well past the fairness horizon N/V."""
        horizon_us = 4.0 * n / self.cfg.v_per_us
        base = self.cfg.lut
        t_shift = max(int(np.ceil(np.log2(max(horizon_us, 1)
                                          / base.t_bins))), 1)
        return LUTConfig(t_shift=t_shift, c_shift=base.c_shift,
                         t_bins=base.t_bins, c_bins=base.c_bins,
                         prob_bits=base.prob_bits)

    def offer(self, stream_id: int, now_us: int) -> bool:
        cfg = self.cfg
        gap = max(now_us - self.t_last, 0) if self.t_last else 0
        self.t_last = now_us
        self.bucket = min(self.bucket + gap, cfg.queue_len * cfg.cost_us)
        self.win_reqs += 1
        self.win_streams.add(stream_id)
        t_i = now_us - self.backlog_t.get(stream_id, now_us)
        c_i = self.backlog_n.get(stream_id, 0)
        prob = int(lut_lookup_np(self.lut, np.asarray([max(t_i, 0)]),
                                 np.asarray([c_i]), self.lut_cfg)[0])
        rand = int(self.rng.integers(0, 1 << cfg.lut.prob_bits))
        granted = (rand < prob) and self.bucket >= cfg.cost_us
        if granted:
            self.bucket -= cfg.cost_us
            self.backlog_n[stream_id] = 0
            self.backlog_t[stream_id] = now_us
            self.admitted += 1
        else:
            self.backlog_n[stream_id] = c_i + 1
            self.backlog_t.setdefault(stream_id, now_us)
            self.denied += 1
        return granted

    def refresh(self) -> None:
        """Control-plane window rollover: rebuild the LUT from observed
        stream count N and request rate Q."""
        n = max(len(self.win_streams), 1)
        q = max(self.win_reqs, 1) / (self.cfg.window_s * 1e6)
        self.lut_cfg = self._adapt_lut_cfg(n)
        self.lut = build_lut(n=n, q=q, v=self.cfg.v_per_us,
                             cfg=self.lut_cfg)
        self.win_reqs = 0
        self.win_streams = set()
