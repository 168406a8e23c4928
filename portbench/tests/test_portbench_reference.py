"""The plain reference agrees with the port bit for bit at a tiny size on
the CPU: verdicts, stats and final state, on the device and farm
drivers, for the CNN and the RNN."""

import time

import pytest
from conftest import tiny_cell

from portbench import harness

CASES = {
    "cnn-device": ("fenix-cnn.device.iscx", {}),
    "rnn-device": ("fenix-rnn.device.iscx", {}),
    "cnn-device-tail": ("fenix-cnn.device.iscx", dict(packets=2900)),
    "rnn-farm": ("fenix-rnn.farm4x4.iscx",
                 dict(batch=128, packets=6000, flows=80)),
    "cnn-farm": ("fenix-rnn.farm4x4.iscx",
                 dict(batch=128, packets=6000, flows=80)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_agrees_with_the_port(case):
    name, kw = CASES[case]
    cell = tiny_cell(name, **kw)
    if case == "cnn-farm":
        cell.config = tiny_cell("fenix-cnn.device.iscx").config
    ctx = harness.run_cell(cell, 2**31 + 99, 0.2, False, "cpu",
                           time.perf_counter())
    assert ctx.checks == {k: 0 for k in ctx.limits}
    assert ctx.correct and ctx.attempted >= 1 and ctx.failed == 0
    stats = [r.inferences for r in ctx.window]
    assert min(stats) > 0
