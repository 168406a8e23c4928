"""The comparison refuses what it must: the control (the reference with
int4 weights in the program's place) and, with the harness's look for a
card skipped, a run whose timed path is broken underneath by each fault
a one-card replay can have.  A sound run at the same size reads 0."""

import time

import pytest
import torch
from conftest import tiny_cell

from portbench import check, control, harness

SEED = 2**31 + 5


def _run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", ["fenix-cnn.device.iscx",
                                  "fenix-rnn.device.iscx"])
def test_control_fails_and_the_program_reads_zero(name):
    out = control.readings(tiny_cell(name), SEED, torch.device("cpu"),
                           program=True)
    assert out["program"] == {k: 0 for k in check.LIMITS}
    assert not check.verdict_of(out["control"])
    assert out["control"]["verdicts_off"] > 0


def _state_unchanged(monkeypatch):
    """Each step leaves the carry as it found it."""
    from repro_torch.core import fenix

    monkeypatch.setattr(fenix, "_store", lambda dst, src: None)


def _half_batch(monkeypatch):
    """Half of each batch is left out: the step sees the first half of
    its packets twice."""
    from repro_torch.core import fenix

    unpack = fenix._unpack

    def half(packed, payload):
        n = packed.shape[-1]
        kept = packed[..., :(n + 1) // 2]
        return unpack(torch.cat([kept, kept[..., :n // 2]], -1), payload)

    monkeypatch.setattr(fenix, "_unpack", half)


def _answer_altered(monkeypatch):
    """One packet's verdict is changed where the system produces the
    replay's answers."""
    from repro_torch.core.fenix import FenixSystem

    run_trace = FenixSystem.run_trace

    def altered(self, trace):
        out = run_trace(self, trace)
        v = out["verdict"]
        i = len(v) // 2
        v[i] = (v[i] + 1) % self.model.num_classes
        return out

    monkeypatch.setattr(FenixSystem, "run_trace", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("name", ["fenix-cnn.device.iscx",
                                  "fenix-rnn.farm4x4.iscx"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_reads_not_correct(monkeypatch, name, fault):
    kw = dict(batch=128, packets=6000, flows=80) if "farm" in name else {}
    cell = tiny_cell(name, **kw)
    FAULTS[fault](monkeypatch)
    ctx = _run(cell)
    assert not ctx.correct
    assert ctx.failed == ctx.attempted
    assert any(v > lim for k, lim in ctx.limits.items()
               for v in [ctx.checks[k]])
