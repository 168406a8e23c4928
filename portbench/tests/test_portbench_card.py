"""On the card: one cell run end to end by its command, and the
comparison's two readings with the port's kernels at a test's size.
Skipped where there is no CUDA device."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT, tiny_cell

from portbench import check, check_train, control, harness

pytestmark = pytest.mark.gpu


def test_a_cell_runs_correct_by_its_command(gpu):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fenix-cnn.device.iscx", "--seed", str(2**31 + 17), "--seconds",
         "2", "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", ["fenix-cnn.device.iscx",
                                  "fenix-rnn.farm4x4.iscx"])
def test_control_fails_where_the_kernels_read_zero(gpu, name):
    cell = tiny_cell(name, batch=128, packets=6000, flows=80,
                     gate_backend="cuda", matmul_backend="cuda",
                     step_backend="graph")
    out = control.readings(cell, 5, gpu, program=True)
    assert out["program"] == {k: 0 for k in check.LIMITS}
    assert not check.verdict_of(out["control"])


def test_the_train_cell_runs_correct_by_its_command(gpu):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fenix-cnn.train-iscx", "--seed", str(2**31 + 18), "--seconds",
         "2", "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {
        "train_kernels_per_step", "train_mfu", "train_device_ms_per_step",
        "train_idle_share"}
    assert 0 < line["metrics"]["train_mfu"]["value"] <= 100
    assert line["metrics"]["train_kernels_per_step"]["value"] > 0
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def test_tf32_fails_the_train_cell_where_the_program_passes(gpu):
    cell = harness.resolve("fenix-cnn.train-iscx")
    out = control.train_readings(cell, 9, gpu, program=True, faults=False,
                                 witness=False)
    assert check_train.verdict_of(out["program"])
    assert not check_train.verdict_of(out["control"])
