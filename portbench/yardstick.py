"""The card's peaks and the arithmetic of the per-layer shares: a
model's multiply-accumulates, the INT8 GEMMs a step needs and the fused
gate's bytes, each turned into the least time the card could take.

Peaks are NVIDIA's published figures for one H100 SXM (dense, at its
700 W limit): 3.35 TB/s of HBM3, 1,979 TOP/s of int8 and 67 TFLOP/s of
float32 on the CUDA cores (TF32 off).  A share is
stated against them with the card's power limit beside it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12
# the admission LUT: t_bins x c_bins int32; registers bucket and t_last
LUT_BYTES = 64 * 32 * 4
GATE_REG_BYTES = 2 * 4 + 4
# int32 lanes in (t_i, c_i, ts, rand16) and one byte out a lane
GATE_LANE_BYTES = 4 * 4 + 1
SERVE_LANES = 1024      # the Model Engine's lanes a step, a pipe


def macs_per_inference(cfg: Dict) -> int:
    """Multiply-accumulates of one feature window through the model."""
    e2, t = 2 * cfg["embed_dim"], cfg["seq_len"]
    if cfg["kind"] == "rnn":
        u = cfg["rnn_units"]
        return t * (e2 * u + u * u) + u * cfg["num_classes"]
    total, c = 0, e2
    for ch in cfg["conv_filters"]:
        total += t * cfg["conv_kernel"] * c * ch
        c = ch
    for fc in cfg["fc_dims"]:
        total += c * fc
        c = fc
    return total + c * cfg["num_classes"]


def train_flops_per_window(cfg: Dict) -> int:
    """Float operations one window costs in a train step: 2 x the
    multiply-accumulates of the forward pass, and twice that for the
    backward pass (the gradients of the activations and of the
    weights)."""
    return 3 * 2 * macs_per_inference(cfg)


def gemm_shapes(cfg: Dict, lanes: int) -> List[Tuple[int, int, int, bool,
                                                     bool]]:
    """(M, K, N, requantized to int8, with bias) of every INT8 GEMM one
    step makes over ``lanes`` feature windows."""
    e2, t, k = 2 * cfg["embed_dim"], cfg["seq_len"], cfg["num_classes"]
    if cfg["kind"] == "rnn":
        u = cfg["rnn_units"]
        return ([(lanes, e2, u, False, True), (lanes, u, u, False, False)]
                * t + [(lanes, u, k, False, True)])
    out, c = [], e2
    for ch in cfg["conv_filters"]:
        out.append((lanes * t, cfg["conv_kernel"] * c, ch, True, True))
        c = ch
    for fc in cfg["fc_dims"]:
        out.append((lanes, c, fc, True, True))
        c = fc
    return out + [(lanes, c, k, False, True)]


def gemm_bound_s(m: int, k: int, n: int, shifted: bool, bias: bool
                 ) -> float:
    """The larger of the bytes (A and B read once, the bias, C written
    once) over HBM bandwidth and 2MNK over the int8 peak."""
    byts = m * k + k * n + (4 * n if bias else 0) \
        + m * n * (1 if shifted else 4)
    return max(byts / HBM_BYTES_PER_S, 2.0 * m * n * k / INT8_OPS_PER_S)


def step_gemm_bound_s(cfg: Dict, lanes: int) -> float:
    return sum(gemm_bound_s(*s) for s in gemm_shapes(cfg, lanes))


def gate_bound_s(pipes: int, n: int) -> float:
    """The fused gate over [pipes, n] lanes: bytes bound (each pipe's
    lanes, LUT and registers once)."""
    return pipes * (n * GATE_LANE_BYTES + LUT_BYTES + GATE_REG_BYTES) \
        / HBM_BYTES_PER_S


def lanes_per_step(mix: Dict) -> int:
    """Feature windows one uniform step serves: every engine serves
    every pipe's lanes."""
    return int(mix.get("num_pipes", 1)) * int(mix.get("num_engines", 1)) \
        * SERVE_LANES
