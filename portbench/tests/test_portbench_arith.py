"""The yardstick's arithmetic, by hand-worked shapes: MACs an
inference, the GEMMs a step and their bounds, the gate's bytes, and the
trace readers' sums."""

import types

import pytest

from portbench import harness, tracing, yardstick
from portbench.yardstick import HBM_BYTES_PER_S, INT8_OPS_PER_S

CNN = {"kind": "cnn", "embed_dim": 16, "seq_len": 9, "num_classes": 7,
       "conv_filters": [64, 128, 256], "conv_kernel": 3,
       "fc_dims": [512, 256], "rnn_units": 128}
RNN = dict(CNN, kind="rnn")


def test_macs_per_inference():
    # conv 9*3*(32*64 + 64*128 + 128*256), FC 256*512 + 512*256, head
    assert yardstick.macs_per_inference(CNN) == \
        9 * 3 * (32 * 64 + 64 * 128 + 128 * 256) + 2 * 256 * 512 + 256 * 7
    assert yardstick.macs_per_inference(CNN) == 1425152
    assert yardstick.macs_per_inference(RNN) == 9 * (32 * 128 + 128 * 128) \
        + 128 * 7 == 185216


def test_gemm_shapes_of_a_step():
    assert yardstick.gemm_shapes(CNN, 1024) == [
        (9216, 96, 64, True, True), (9216, 192, 128, True, True),
        (9216, 384, 256, True, True), (1024, 256, 512, True, True),
        (1024, 512, 256, True, True), (1024, 256, 7, False, True)]
    rnn = yardstick.gemm_shapes(RNN, 16384)
    assert len(rnn) == 19 and rnn[0] == (16384, 32, 128, False, True)
    assert rnn[1] == (16384, 128, 128, False, False)
    assert rnn[-1] == (16384, 128, 7, False, True)


def test_gemm_bound_takes_the_larger_term():
    # bytes: A 9216x96, B 96x64, bias 64 int32, C 9216x64 int8
    assert yardstick.gemm_bound_s(9216, 96, 64, True, True) == \
        pytest.approx((9216 * 96 + 96 * 64 + 256 + 9216 * 64)
                      / HBM_BYTES_PER_S)
    # 4096^3: 2*4096^3 operations outweigh 3 x 16 MiB (+ int32 C)
    assert yardstick.gemm_bound_s(4096, 4096, 4096, False, False) == \
        pytest.approx(2 * 4096 ** 3 / INT8_OPS_PER_S)


def test_gate_bound_counts_each_pipe():
    one = (4096 * 17 + 64 * 32 * 4 + 12) / HBM_BYTES_PER_S
    assert yardstick.gate_bound_s(1, 4096) == pytest.approx(one)
    assert yardstick.gate_bound_s(4, 4096) == pytest.approx(4 * one)
    assert yardstick.lanes_per_step({"num_pipes": 4, "num_engines": 4}) \
        == 16384


def test_union_and_gaps():
    merged = tracing._union([(0, 10), (5, 20), (25, 30), (30, 31),
                             (100, 110)])
    assert merged == [(0, 20), (25, 31), (100, 110)]
    host = [types.SimpleNamespace(time_range=types.SimpleNamespace(
        start=s, end=e), name=n) for s, e, n in
        [(0, 200, "portbench"), (30, 120, "aten::copy_")]]
    gaps = dict(tracing._gaps(merged, host))
    assert gaps["device: between kernels (< 10 us)"] == pytest.approx(5e-6)
    assert gaps["host: aten::copy_"] == pytest.approx(69e-6)


def _ctx(units, mix):
    reading = object.__new__(tracing.TraceReading)
    reading.units = units
    return types.SimpleNamespace(trace=reading, on_card=True, config=CNN,
                                 mix=mix)


def test_roofline_readers_hold_whole_units():
    mix = {"num_pipes": 1, "num_engines": 1, "batch_size": 4096}
    full = [("int8_gemm_kernel", 1e-5)] * 6 + [("fused_gate_x", 2e-6)]
    short = [("int8_gemm_kernel", 1e-5)] * 5
    ctx = _ctx({0: full, 1: full, 2: short}, mix)
    bound = yardstick.step_gemm_bound_s(CNN, 1024)
    assert harness.reader("int8_gemm_roofline").read(ctx) == \
        pytest.approx(100 * bound / 6e-5)
    assert harness.reader("fused_gate_roofline").read(ctx) == \
        pytest.approx(100 * yardstick.gate_bound_s(1, 4096) / 2e-6)
    assert harness.reader("int8_gemm_roofline").read(
        _ctx({0: short}, mix)) is None
