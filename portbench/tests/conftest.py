"""Shared helpers of the benchmark's tests: the checkout's root and the
port's sources on the path, tiny cells made from the committed ones, and
the ``gpu`` fixture that skips a test where no card is present."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import harness  # noqa: E402

TINY_MODELS = {
    "cnn": {"embed_dim": 4, "conv_filters": [8], "fc_dims": [16]},
    "rnn": {"embed_dim": 4, "rnn_units": 16},
}


def tiny_cell(name: str, packets: int = 3000, flows: int = 40,
              batch: int = 256, **mix_kw) -> harness.Cell:
    """Cell ``<config>.<mix>`` (of BENCHMARK.json or not) cut to a CPU
    test's size: the tiny model of its kind, a few thousand packets,
    small batches, the CPU's backends."""
    config, mix = name.split(".", 1)
    bench = harness.load_bench()
    cell = harness.Cell(
        name, 1, json.loads((ROOT / "portbench" / "configs"
                             / f"{config}.json").read_text()),
        json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json")
                   .read_text()),
        copy.deepcopy(bench["end_to_end"]), copy.deepcopy(bench["per_layer"]))
    cell.config.update(TINY_MODELS[cell.config["kind"]])
    cell.mix.update(packets=packets, flows=flows, batch_size=batch,
                    control_plane_every=2, captures=2, calib=64,
                    gate_backend=None, matmul_backend=None,
                    step_backend=None)
    cell.mix.update(mix_kw)
    return cell


def tiny_train_cell(config: str = "fenix-cnn", **mix_kw) -> harness.Cell:
    """The ``train-iscx`` cell on configuration ``config`` cut to a CPU
    test's size: the tiny model of its kind, 40 flows, batch 16, jobs of
    8 eager steps."""
    cell = harness.resolve("fenix-cnn.train-iscx")
    cell.config = json.loads((ROOT / "portbench" / "configs"
                              / f"{config}.json").read_text())
    cell.config.update(TINY_MODELS[cell.config["kind"]])
    cell.mix.update(flows=40, batch=16, job_steps=8, warmup_steps=2,
                    trace_steps=2, step_backend=None)
    cell.mix.update(mix_kw)
    return cell


@pytest.fixture
def gpu():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
