"""The readers of the program's telemetry (``portbench/probes.py``):
None off the card, and the hand-computed value on made-up readings."""

import sys

import pytest

from portbench import harness
from portbench.runners.replay import Context

STAGES = ("deliver", "flow", "draw", "gate", "table", "enqueue_ring",
          "dequeue", "infer", "push", "control_plane", "store")
READERS = ("flow_ms_per_step", "draw_ms_per_step", "table_ms_per_step",
           "vector_io_ms_per_step", "model_engine_ms_per_step",
           "carry_store_ms_per_step", "staging_ms_per_replay",
           "device_gap_ms_per_replay")


def _replay(k, chunks, tail, stage_ns, gap_ns):
    """A made-up replay: stage s takes (index of s + 1) x k x 1000 ns
    over the replay; its stage span lasts stage_ns."""
    ns = {s: (i + 1) * k * 1000 for i, s in enumerate(STAGES)}
    return {"id": k, "driver": "device",
            "spans": [{"name": "replay", "parent": None, "start_ns": 0,
                       "end_ns": 10 ** 9},
                      {"name": "stage", "parent": 0, "start_ns": 100,
                       "end_ns": 100 + stage_ns}],
            "counters": {"chunks": chunks, "tail_steps": tail},
            "device": {"ns": ns, "marks": {}, "gap_ns": gap_ns,
                       "spans": chunks + 5}}


def _ctx(on_card=True, telemetry=None):
    ctx = Context(config={}, mix={}, setup_s=0.0, window_s=1.0, window=[],
                  steps=[])
    if on_card:
        ctx.device = {"platform": "gpu"}
    if telemetry is not None:
        ctx.telemetry = telemetry
    return ctx


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_off_the_card(name):
    assert harness.reader(name).read(_ctx(on_card=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_a_device_reading(name):
    r = _replay(1, 4, 0, 10, 5)
    r["device"] = None
    assert harness.reader(name).read(_ctx(telemetry=[r])) is None


def test_the_pass_raises_on_the_card_without_a_seed(monkeypatch):
    # a caller other than run.py gives no --seed: the metrics must not
    # drop out of the line unnoticed
    monkeypatch.setattr(sys, "argv", ["portbench"])
    with pytest.raises(RuntimeError, match="--seed"):
        harness.reader("flow_ms_per_step").read(_ctx())


def test_readers_compute_the_hand_values():
    # two replays: 4 chunks and a tail round (5 steps), 6 chunks (6 steps)
    tel = [_replay(1, 4, 2, 6_000_000, 3_000_000),
           _replay(2, 6, 0, 8_000_000, 5_000_000)]
    ctx = _ctx(telemetry=tel)
    steps = 11

    def per_step(*stages):
        idx = [STAGES.index(s) + 1 for s in stages]
        return sum(i * (1 + 2) * 1000 for i in idx) / steps / 1e6

    want = {"flow_ms_per_step": per_step("flow"),
            "draw_ms_per_step": per_step("draw"),
            "table_ms_per_step": per_step("table"),
            "vector_io_ms_per_step": per_step("deliver", "enqueue_ring",
                                              "dequeue", "push"),
            "model_engine_ms_per_step": per_step("infer"),
            "carry_store_ms_per_step": per_step("store"),
            "staging_ms_per_replay": 7.0,
            "device_gap_ms_per_replay": 4.0}
    for name, value in want.items():
        assert harness.reader(name).read(ctx) == pytest.approx(value,
                                                               rel=1e-12)


def test_the_new_metrics_are_entries_of_both_cells():
    bench = harness.load_bench()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]
             if harness.resolve(w["name"], bench).mix["kind"] == "replay"]
    for name in READERS:
        m = entries[name]
        assert m["moves"] == "replay_pps" and m["workloads"] == cells
        assert m["source"] == "program_counter"
