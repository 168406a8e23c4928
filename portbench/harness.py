"""The benchmark's driver: resolves a cell by name to its files, runs it
once, and prints the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A cell (``BENCHMARK.json`` ``workloads``) names a configuration, whose
file holds the model's widths, and a traffic mix, read from
``portbench/traffic/<mix>.json``; the mix's ``kind`` names the runner,
``portbench/runners/<kind>.py``.  Each metric is read by
``portbench/metrics/<metric>.py`` (``read(ctx)``: a number, or None when
the run holds nothing to read).  So a cell, a mix or a metric is added
by new files and new entries alone.

The run's last stdout line is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the same numbers end stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in the process that prints a result,
# compared by top-level name
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_bench(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, bench: Optional[Dict] = None,
            root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics: an
    end-to-end metric applies where its ``workloads`` (if any) name the
    cell; a per-layer one where its ``workloads`` name it or, without
    them, where the cell reports the metric it ``moves``."""
    bench = bench if bench is not None else load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the cells are "
                       f"{sorted(cells)}")
    wl = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]

    def named(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if named(m)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return Cell(name, int(wl["chips"]), _json(root / conf["file"]),
                _json(HERE / "traffic" / f"{wl['traffic']}.json"), e2e, per)


def reader(name: str):
    """The reader module of metric ``name`` (a metric's name may hold a
    dot, so it is loaded from its file)."""
    key = f"portbench.metrics.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, HERE / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def runner(kind: str):
    return importlib.import_module(f"portbench.runners.{kind}")


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def read_metrics(metrics: List[Dict], ctx) -> Dict:
    out = {}
    for m in metrics:
        v = reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell: Cell, ctx, trace: bool) -> Dict:
    """The result object; ``checks`` last."""
    line = {"correct": ctx.correct, "attempted": ctx.attempted,
            "failed": ctx.failed,
            "metrics": read_metrics(cell.per_layer if trace
                                    else cell.end_to_end, ctx),
            "device": ctx.device}
    if trace and ctx.breakdown is not None:
        line["breakdown"] = ctx.breakdown
    line["checks"] = {k: {"value": v, "limit": ctx.limits[k]}
                      for k, v in ctx.checks.items()}
    return line


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float):
    """Runs the cell once on ``dev`` (no look for a card: tests call
    this on the CPU); returns the runner's context."""
    return runner(cell.mix["kind"]).run(cell, seed, seconds, trace, dev,
                                        t_start)


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def main(argv: Optional[List[str]], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(args.workload)
    _cache_dirs()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    line = result_line(cell, ctx, bool(args.trace))
    print(f"portbench: {cell.name} seed {args.seed}: set-up "
          f"{ctx.setup_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in ctx.setup_parts.items())
          + f"), window {ctx.window_s:.3f} s, {ctx.attempted} "
          f"attempted, reference {ctx.reference_s:.3f} s",
          file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
