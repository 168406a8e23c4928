"""Each cell of BENCHMARK.json resolves to its files by name, and the
file keeps to the benchmark's contract."""

import json
import re

import pytest
from conftest import ROOT

from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.resolve(name)
    wl = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert cell.config["name"] == wl["config"]
    assert cell.mix == json.loads(
        (ROOT / "portbench" / "traffic" / f"{wl['traffic']}.json")
        .read_text())
    assert harness.runner(cell.mix["kind"]).run
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]).read), m["name"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= e2e


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.resolve("no-such.cell")


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == []
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in BENCH["end_to_end"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", ["fenix-cnn", "fenix-rnn"])
def test_configuration_holds_the_published_widths(name):
    from portbench import yardstick

    conf = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())
    assert (conf["embed_dim"], conf["seq_len"], conf["num_classes"]) == \
        (16, 9, 7)
    assert (conf["conv_filters"], conf["fc_dims"], conf["rnn_units"]) == \
        ([64, 128, 256], [512, 256], 128)
    assert yardstick.macs_per_inference(conf) == conf["macs_per_inference"]
