"""The ``train`` runner and its comparison on the CPU at a tiny size:
the cells resolve to their scoped metrics, the replay captures are
unchanged by the training windows, a run completes and reads correct on
one step graph, the plain reference follows the program's steps, and a
timed path broken underneath reads not correct."""

import json
import time
import zlib

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny_train_cell

from portbench import check_train, control, harness, inputs
from portbench.reference import train_ref
from portbench.runners import train as tr

SEED = 2**31 + 21
REPLAY = ["fenix-cnn.device.iscx", "fenix-rnn.device.iscx"]
REPLAY_E2E = ["replay_pps", "replay_ms_p95", "setup_s"]
REPLAY_PER_LAYER = [
    "launch_calls_per_step", "fused_gate_roofline", "replay_mfu",
    "int8_gemm_roofline", "device_idle_share", "device_ms_per_step",
    "flow_ms_per_step", "draw_ms_per_step", "table_ms_per_step",
    "vector_io_ms_per_step", "model_engine_ms_per_step",
    "carry_store_ms_per_step", "staging_ms_per_replay",
    "device_gap_ms_per_replay"]


def _run(cell, seconds=0.2, trace=False):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", REPLAY)
def test_replay_cells_keep_their_metrics(name):
    cell = harness.resolve(name)
    assert [m["name"] for m in cell.end_to_end] == REPLAY_E2E
    assert [m["name"] for m in cell.per_layer] == REPLAY_PER_LAYER


def test_the_train_cell_has_its_own_metrics_and_setup():
    cell = harness.resolve("fenix-cnn.train-iscx")
    assert [m["name"] for m in cell.end_to_end] == \
        ["train_windows_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "train_kernels_per_step", "train_mfu", "train_device_ms_per_step",
        "train_idle_share"}
    assert {m["moves"] for m in cell.per_layer} == {"train_windows_per_s"}
    assert cell.mix["kind"] == "train" and cell.chips == 1


def _digest(caps):
    d = 0
    for c in caps:
        for k in sorted(c):
            d = zlib.crc32(np.ascontiguousarray(c[k]).tobytes(), d)
    return d


@pytest.mark.parametrize("seed,want", [(7, 1393739179),
                                       (2**31 + 12345, 1390914048)])
def test_replay_captures_are_unchanged(seed, want):
    # digests of the full device.iscx captures as made before the
    # training windows shared their flow generator
    mix = json.loads((ROOT / "portbench" / "traffic" / "device.iscx.json")
                     .read_text())
    assert _digest(inputs.make_captures(mix, seed)) == want


def test_training_windows_follow_the_seed():
    mix = tiny_train_cell().mix
    x, y, w = inputs.make_training_windows(mix, SEED)
    x2, y2, w2 = inputs.make_training_windows(mix, SEED)
    x3, _, _ = inputs.make_training_windows(mix, SEED + 1)
    assert x.shape[1:] == (9, 2) and x.dtype == np.int32
    assert len(x) == len(y) == len(w) > mix["flows"]
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    assert np.array_equal(w, w2) and not np.array_equal(x[:10], x3[:10])
    # inverse-frequency weights: every class present sums to N / k
    k = len(mix["classes"])
    for c in np.unique(y):
        assert w[y == c].sum() == pytest.approx(len(y) / k, rel=1e-5)


def test_float_params_follow_the_seed():
    cfg = tiny_train_cell().config
    a = inputs.make_float_params(cfg, SEED, "cpu")
    b = inputs.make_float_params(cfg, SEED, "cpu")
    c = inputs.make_float_params(cfg, 5, "cpu")
    assert list(a) == list(inputs.float_shapes(cfg))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv0/w"], c["conv0/w"])
    assert float(a["conv0/b"].abs().sum()) == 0.0


def test_a_tiny_run_reads_correct_on_one_step_graph():
    cell = tiny_train_cell()
    ctx = _run(cell, trace=True)
    assert ctx.correct and ctx.failed == 0, ctx.checks
    assert ctx.checks.keys() == check_train.LIMITS.keys()
    assert ctx.step_graphs == 1
    assert ctx.attempted == len(ctx.window) * cell.mix["job_steps"]
    e2e = harness.read_metrics(cell.end_to_end, ctx)
    assert e2e["train_windows_per_s"]["value"] > 0
    # the device's metrics are not read off the card
    assert harness.read_metrics(cell.per_layer, ctx) == {}


def test_a_new_step_graph_in_the_window_is_refused(monkeypatch):
    start = tr.Feed.start

    def new_data(self, seed, job):
        self.data = dict(self.data)     # a new source: new step buffers
        start(self, seed, job)

    monkeypatch.setattr(tr.Feed, "start", new_data)
    with pytest.raises(RuntimeError, match="step graphs"):
        _run(tiny_train_cell())


@pytest.mark.parametrize("config", ["fenix-cnn", "fenix-rnn"])
def test_the_reference_follows_the_program_over_a_job(config):
    cell = tiny_train_cell(config, job_steps=12)
    out = control.train_readings(cell, SEED, torch.device("cpu"),
                                 program=True, faults=False, witness=False)
    nums = out["program"]
    assert all(v < 1e-5 for v in nums.values()), nums


def _index_shifted(monkeypatch):
    """One row of each batch is its neighbour where the program takes
    its batch."""
    from repro_torch.train.trainer import Trainer

    take = Trainer._buffers

    def shifted(self, batches, item):
        idx = np.array(item["index"])
        idx[0] = (idx[0] + 1) % batches.n
        return take(self, batches, {"index": idx})

    monkeypatch.setattr(Trainer, "_buffers", shifted)


def _update_skipped(monkeypatch):
    """Step 2 leaves the leaves as they were (its moments move)."""
    from repro_torch.train import trainer

    apply = trainer.apply_updates

    def skip(p, g, s, cfg):
        new_p, new_s, om = apply(p, g, s, cfg)
        if int(s["step"]) == 1:
            new_p = {k: v.clone() for k, v in p.items()}
        return new_p, new_s, om

    monkeypatch.setattr(trainer, "apply_updates", skip)


def _state_unchanged(monkeypatch):
    """Every step returns its state unchanged."""
    from repro_torch.train import trainer

    monkeypatch.setattr(trainer, "_select", lambda ok, dst, new: None)


def _half_batch(monkeypatch):
    """The loss is the mean over the first half of the batch."""
    from repro_torch.models import traffic

    loss = traffic.loss_fn

    def half(params, cfg, batch, table=None):
        n = (batch["label"].shape[0] + 1) // 2
        return loss(params, cfg, {k: v[:n] for k, v in batch.items()},
                    table)

    monkeypatch.setattr(traffic, "loss_fn", half)


def _answer_altered(monkeypatch):
    """The loss a step reports is off by one part in a thousand."""
    from repro_torch.train.trainer import Trainer

    step = Trainer.train_step

    def altered(self, batches, item):
        out = step(self, batches, item)
        out["loss"] *= 1.001
        return out

    monkeypatch.setattr(Trainer, "train_step", altered)


# a dropped weight decay is not among them: over three steps it moves
# the leaves by less than a relu kink's rounding does (PERF.md section 2)
FAULTS = {"index_shifted": _index_shifted,
          "update_skipped": _update_skipped,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_reads_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    ctx = _run(tiny_train_cell())
    assert not ctx.correct
    assert any(ctx.checks[k] > lim for k, lim in ctx.limits.items())


@pytest.mark.parametrize("fault", ["half_batch", "index_shift",
                                   "skip_update"])
def test_each_reference_fault_moves_a_number(fault):
    cell = tiny_train_cell()
    x, y, w = inputs.make_training_windows(cell.mix, SEED)
    data = {"payload": x, "label": y, "weight": w}
    init = inputs.make_float_params(cell.config, SEED, "cpu")
    rows = [np.arange(i * 16, i * 16 + 16) for i in range(4)]
    sound = train_ref.run_job(cell.config, cell.mix, data, init, rows,
                              "cpu", check_train.KEEP)
    bad = train_ref.run_job(cell.config, cell.mix, data, init, rows, "cpu",
                            check_train.KEEP, fault=fault)
    bad["m1"] = {k: g * (1 - cell.mix["b1"]) for k, g in
                 bad["grad1"].items()}
    nums = check_train.compare(bad, sound, init, cell.mix["b1"])
    assert not check_train.verdict_of(nums), nums
