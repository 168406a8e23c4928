"""The replay telemetry (``repro_torch._telemetry``): host spans,
counters and device probes on the device, pipes and farm drivers.

On the CPU, at tiny sizes with the eager step backend: telemetry on
gives the replays of telemetry off bit for bit; off, no probe and no
profiler span is entered; the spans form one closed tree per replay; the
counters are the hand counts; ``drain()`` clears.  The tests marked
``gpu`` hold the same on the card, where the probes run inside the chunk
graphs.  Imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest tests/test_torch_telemetry.py -q
"""

import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same, cuda_device  # noqa: E402,F401
from repro_torch import _telemetry as tm  # noqa: E402
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine.inference import ByLenModel  # noqa: E402
from repro_torch.data.synthetic_traffic import (  # noqa: E402
    make_flows, packet_stream)

BATCH, CPE, LIMIT = 64, 2, 700          # 10 full chunks and a tail of 60
DRIVERS = {"device": {}, "pipes": {"num_pipes": 2},
           "farm": {"num_pipes": 2, "num_engines": 2}}
# the host spans each driver's replay records (the root first)
SPANS = {"device": ["replay", "reset", "stage", "load_bufs", "enqueue",
                    "finish"],
         "host": ["replay", "reset"]}
SPANS["pipes"] = SPANS["farm"] = SPANS["device"]


@pytest.fixture(scope="module")
def stream():
    return packet_stream(make_flows("iscx", 40, seed=7), limit=LIMIT)


@pytest.fixture(autouse=True)
def _clean():
    tm.drain()
    yield
    tm.drain()


def make_system(driver, device="cpu", batch=BATCH):
    cfg = FenixConfig(batch_size=batch, control_plane_every=CPE,
                      driver=driver, **DRIVERS.get(driver, {}))
    return FenixSystem(cfg, ByLenModel(), device=device)


def carry(system):
    if system.cfg.driver in ("pipes", "farm"):
        out = {"state": system.pstate, "queues": system.pqueues,
               "dl": system.pdl}
        if system.cfg.driver == "farm":
            out["eq"] = system.eq
        return out
    return {"state": system.state, "queues": system.queues}


def replays(system, stream, n=2):
    """``n`` replays from a fresh state each: (verdicts, stats, carry)."""
    out = []
    for _ in range(n):
        system.reset()
        v = system.run_trace(stream)["verdict"]
        out.append((v, json.dumps(system.stats), carry(system)))
    return out


def assert_replays_equal(a, b):
    for (va, sa, ca), (vb, sb, cb) in zip(a, b):
        np.testing.assert_array_equal(va, vb)
        assert sa == sb
        assert_same(ca, cb)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_telemetry_on_gives_the_same_replays(driver, stream):
    off = replays(make_system(driver), stream)
    with tm.enabled():
        on = replays(make_system(driver), stream)
    assert_replays_equal(off, on)
    assert len(tm.drain()) == 2


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_off_enters_no_probe_and_no_profiler_span(driver, stream,
                                                  monkeypatch):
    probes, spans = [], []
    real_probe, real_profiled = tm._probe, tm._profiled
    def probe(*a):
        probes.append(a)
        real_probe(*a)

    def profiled(name):
        spans.append(name)
        return real_profiled(name)

    monkeypatch.setattr(tm, "_probe", probe)
    monkeypatch.setattr(tm, "_profiled", profiled)
    system = make_system(driver)
    replays(system, stream)
    assert probes == [] and spans == [] and tm.drain() == []
    with tm.enabled():
        replays(system, stream, 1)
    # on: the probes are entered (they launch nothing on the CPU); no
    # profiler session, so no profiler span
    assert probes and spans == []
    assert {a[1] for a in probes} == {0, 1, 2}


@pytest.mark.parametrize("driver", list(DRIVERS) + ["host"])
def test_spans_form_one_tree_per_replay(driver, stream):
    system = make_system(driver)
    with tm.enabled():
        replays(system, stream)
        system.run_trace(stream)            # a replay without reset()
    got = tm.drain()
    assert [r["driver"] for r in got] == [driver] * 3
    assert len({r["id"] for r in got}) == 3
    for r in got[:2]:
        names = [s["name"] for s in r["spans"]]
        assert names == SPANS[driver], names
    assert "reset" not in [s["name"] for s in got[2]["spans"]]
    for r in got:
        spans = r["spans"]
        assert spans[0]["name"] == "replay" and spans[0]["parent"] is None
        for i, s in enumerate(spans):
            assert s["name"] in tm.SPANS
            assert s["end_ns"] is not None and s["start_ns"] <= s["end_ns"]
            if i:
                p = spans[s["parent"]]
                assert s["parent"] < i
                assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                    <= p["end_ns"]
        assert r["device"] is None          # the CPU reads no device time


def _hand_counts(driver, system, stream):
    """Chunks and tail steps, counted from the trace's length, the
    batch and (pipes, farm) each pipe's share of the routed trace; the
    eager backend captures no graph."""
    n = len(stream["ts_us"])
    if driver == "device":
        chunks, rest = divmod(n, BATCH)
        return {"chunks": chunks, "tail_steps": int(rest > 0),
                "graph_captures": 0}
    _, _, counts = system._route_pipes(stream)
    return {"chunks": int((counts // BATCH).max()),
            "tail_steps": int((counts % BATCH > 0).sum()),
            "graph_captures": 0}


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_counters_are_the_hand_counts(driver, stream):
    system = make_system(driver)
    with tm.enabled():
        replays(system, stream)
    want = _hand_counts(driver, system, stream)
    got = tm.drain()
    assert len(got) == 2
    for r in got:
        assert r["counters"] == want


def test_drain_returns_each_replay_once(stream):
    system = make_system("device")
    with tm.enabled():
        replays(system, stream, 3)
        first = tm.drain()
        assert len(first) == 3 and tm.drain() == []
        replays(system, stream, 1)
    assert len(tm.drain()) == 1
    replays(system, stream, 1)              # off: nothing recorded
    assert tm.drain() == []


def test_profiler_session_sees_the_program_spans(stream):
    from torch.profiler import ProfilerActivity, profile

    system = make_system("pipes")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        replays(system, stream, 1)
    names = {e.name for e in prof.events()}
    assert {f"fenix.{s}" for s in SPANS["pipes"]} <= names
    assert tm.drain() == []


# -- on the card -----------------------------------------------------------

CARD_BATCH = 512


@pytest.fixture(scope="module")
def card_stream():
    return packet_stream(make_flows("iscx", 200, seed=3),
                         limit=40 * CARD_BATCH + 300)


@pytest.mark.gpu
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_card_telemetry_replays_equal_untraced_ones(driver, card_stream,
                                                    cuda_device):
    system = make_system(driver, cuda_device, CARD_BATCH)
    off = replays(system, card_stream)
    with tm.enabled():
        on = replays(system, card_stream)   # no_host_sync holds in the loop
    again = replays(system, card_stream, 1)
    assert_replays_equal(off, on)
    assert_replays_equal(off, again)
    assert system.host_syncs == 0
    assert sorted(system._graphs) == sorted(system._traced_graphs) \
        == [False, True]
    got = tm.drain()
    assert [r["counters"]["graph_captures"] for r in got] == [2, 0]


@pytest.mark.gpu
def test_card_probes_split_each_chunk(card_stream, cuda_device):
    from torch.profiler import ProfilerActivity, profile

    system = make_system("device", cuda_device, CARD_BATCH)
    replays(system, card_stream, 1)         # the untraced graphs
    with tm.enabled():
        replays(system, card_stream, 3)
    got = tm.drain()[1:]
    chunks = got[0]["counters"]["chunks"]
    # the chunks that end a window (the tail's batch, the 41st, does not)
    cps = chunks // CPE
    for r in got:
        dev = r["device"]
        assert r["counters"]["graph_captures"] == 0
        assert dev["spans"] == 3 + chunks + 2   # reset, stage, buffers,
        # the chunks, the tail, the finish
        for s in tm.STAGES:
            assert dev["ns"][s] > 0, s
        marks = {s: chunks + 1 for s in tm.STAGES}
        marks.update(control_plane=cps, store=2 * (chunks + 1))
        assert {s: dev["marks"][s] for s in tm.STAGES} == marks
        assert dev["gap_ns"] > 0
    # the profiled replays after the telemetry pass capture nothing
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replays(system, card_stream, 2)
    assert system.capture_s == 0.0
    names = {e.name for e in prof.events()}
    assert {"fenix.replay", "fenix.stage", "fenix.finish"} <= names
    assert not any("probe" in n for n in names)


def _profiled(system, stream, n=2):
    """The device events' names and the device's busy microseconds (the
    union of their intervals) over ``n`` profiled replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replays(system, stream, n)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return {e.name for e in dev}, busy


@pytest.mark.gpu
def test_card_profiler_spans_add_no_device_time(card_stream, cuda_device,
                                                monkeypatch):
    # the program's spans are host ops: none reaches the device timeline,
    # and the busy time the profiler reads is that of a run without them
    # (a device-side range over a span would add the span's idle gaps)
    system = make_system("device", cuda_device, CARD_BATCH)
    replays(system, card_stream, 1)         # the graphs
    spans, bare = [], []
    for _ in range(2):
        spans.append(_profiled(system, card_stream))
        with monkeypatch.context() as m:
            m.setattr(tm, "_profiled",
                      lambda name: contextlib.nullcontext())
            bare.append(_profiled(system, card_stream))
    for names, _ in spans:
        assert not any(n.startswith("fenix.") for n in names)
    with_spans, without = (sum(b for _, b in r) for r in (spans, bare))
    assert abs(with_spans - without) <= 0.1 * without
    assert system.capture_s == 0.0
