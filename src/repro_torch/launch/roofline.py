"""Roofline analysis from the single-card dry-run artifacts: the port of
``repro/launch/roofline.py`` for one NVIDIA H100.

Three terms per (arch x shape), one card, the H100 SXM's published
dense peaks (NVIDIA data sheet):

  compute    = traced_FLOPs / (chips * 989e12)     [s]  bf16 tensor cores
  memory     = bytes / (chips * 3.35e12)           [s]  HBM3
  collective = 0                                        one card: no
                                                        interconnect term

FLOPs come from the two-point layer extrapolation of the traced steps
(cost_*.json, exact for homogeneous stacks: run_all_dryruns.py); the
memory term is the fused floor of ``analytic_memory_bytes`` (arguments
read and written once, plus residual-stream traffic), the traced unfused
bytes kept beside it as ``bytes_per_device_raw``.  MODEL_FLOPS = 6*N*D
(2*N*D + attention for inference shapes) flags remat/dispatch waste via
the useful-compute ratio.  The reference's key names are kept
(``hlo_flops_global`` is the traced steps' FLOPs here).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--tag baseline]
      [--out-dir DIR] [--json-out cells.json]
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.run_all_dryruns import RESULTS_DIR
from repro_torch.models.api import model_flops

PEAK_FLOPS = 989e12          # H100 SXM, bf16 tensor cores, dense
HBM_BW = 3.35e12             # H100 SXM, HBM3 bytes/s
CARD_GB = 80.0               # H100 SXM, GB of HBM3


def load_cells(tag: str = "baseline", results_dir: str = RESULTS_DIR
               ) -> List[Dict]:
    """Join cost_* (extrapolated) with proof_* (memory) per cell."""
    tagdir = os.path.join(results_dir, tag)
    cells = []
    for path in sorted(glob.glob(os.path.join(tagdir, "cost_*.json"))):
        with open(path) as f:
            cost = json.load(f)
        arch, shape = cost["arch"], cost["shape"]
        cell = {"arch": arch, "shape": shape, "status": cost["status"]}
        if cost["status"] != "ok":
            cells.append(cell)
            continue
        proof_p = os.path.join(tagdir, f"proof_{arch}_{shape}_card.json")
        proof = {}
        if os.path.exists(proof_p):
            with open(proof_p) as f:
                proof = json.load(f)
        cell.update(analyse(arch, shape, cost, proof))
        cells.append(cell)
    for path in sorted(glob.glob(os.path.join(tagdir, "skip_*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


_ACT_RW_PER_LAYER = 8.0   # residual-equivalent reads+writes, fused blocks


def _layers_of(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.num_encoder_layers + cfg.num_decoder_layers
    return cfg.num_layers


def analytic_memory_bytes(cfg, shape, arg_bytes_dev: float,
                          overrides: Dict, chips: int = 1) -> float:
    """Fused memory floor, per device.

    args r/w (params/opt/cache/batch; dtype effects like int8 weights or
    int8 KV arrive through arg_bytes_dev, which is extrapolated from the
    variant's own dry run) + activation residual traffic.  The traced
    ``bytes_accessed`` (eager PyTorch, op by op) is kept as the *unfused
    upper bound*.
    """
    d, ll = cfg.d_model, _layers_of(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        remat = str(overrides.get("remat_policy", cfg.remat_policy))
        fwd_mult = {"nothing": 3.0, "dots": 2.5, "none": 2.0}.get(remat, 3.0)
        args_rw = 2.0 * arg_bytes_dev           # read + write params/opt
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        fwd_mult = 1.0
        args_rw = arg_bytes_dev                 # read params, write cache
    else:
        tokens = shape.global_batch
        fwd_mult = 1.0
        args_rw = arg_bytes_dev                 # read params + cache
    act = _ACT_RW_PER_LAYER * fwd_mult * tokens * d * ll * 2.0 / chips
    return args_rw + act


def _cell_shape(shape_name: str, run: Dict):
    """The shape a dry run traced: ``SHAPES``' own unless it was cut
    (``global_batch`` / ``seq_len`` recorded by ``run_cell``)."""
    shape = SHAPES[shape_name]
    return dataclasses.replace(
        shape, global_batch=run.get("global_batch", shape.global_batch),
        seq_len=run.get("seq_len", shape.seq_len))


def analyse(arch: str, shape_name: str, cost: Dict,
            proof: Optional[Dict] = None, chips: int = 1) -> Dict:
    pts = cost.get("point_results") or []
    run = pts[0] if pts else (proof or {})
    cfg = get_config(arch, reduced=bool(run.get("reduced")))
    shape = _cell_shape(shape_name, run)
    flops_dev = cost["flops"]
    bytes_raw = cost["bytes_accessed"]
    overrides = {}
    if pts:
        overrides = pts[0].get("overrides", {})
    arg_dev = cost.get("arg_bytes_per_device")
    if arg_dev is None and len(pts) == 2 and "points" in cost:
        a1 = pts[0]["memory"]["arg_bytes_per_device_analytic"]
        a2 = pts[1]["memory"]["arg_bytes_per_device_analytic"]
        x1, x2 = cost["points"]
        arg_dev = a1 + (a2 - a1) / (x2 - x1) * (cost["x_full"] - x1)
    bytes_dev = analytic_memory_bytes(cfg, shape, arg_dev or 0.0,
                                      overrides, chips)
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = flops_dev * chips
    out = {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "bytes_per_device_raw": bytes_raw,
        "collective_bytes_per_device": 0.0,
        "collective_per_op": {},
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "step_time_s": max(terms.values()),
        "roofline_fraction": t_compute / max(terms.values())
        if max(terms.values()) > 0 else 0.0,
        "mfu_vs_model_flops": (mf / chips / PEAK_FLOPS)
        / max(terms.values()) if max(terms.values()) > 0 else 0.0,
    }
    if proof and proof.get("status") == "ok":
        mem = proof.get("memory", {})
        out["hbm_args_gb"] = (mem.get("argument_bytes") or 0) / 1e9
        out["hbm_temp_gb"] = (mem.get("temp_bytes") or 0) / 1e9
        out["fits_card"] = (out["hbm_args_gb"] + out["hbm_temp_gb"]) \
            <= CARD_GB
        out["trace_s"] = proof.get("trace_s")
    return out


def analyse_run(res: Dict) -> Dict:
    """``analyse`` of one full-depth ``dryrun.run_cell`` result (no
    extrapolation: its own FLOPs and arguments)."""
    cost = dict(res["cost"], arg_bytes_per_device=res["memory"]
                ["arg_bytes_per_device_analytic"])
    return analyse(res["arch"], res["shape"], cost, res, res["chips"])


def suggestion(cell: Dict) -> str:
    if cell.get("dominant") == "memory":
        return "cut bytes: int8 weights, fused attention (no score spill), " \
               "bf16 cache"
    return "compute-bound: reduce remat recompute / causal-band waste"


def table(cells: List[Dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| 6ND/HLO | MFU | fits card |")
    sep = "|" + "---|" * 9
    rows = [hdr, sep]
    for c in sorted(cells, key=lambda x: (x["arch"], x["shape"])):
        if c.get("status") == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | skipped"
                        f" | — | — | — |")
            continue
        if c.get("status") != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ? | ? | ? | error "
                        f"| ? | ? | ? |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['compute_s']:.3e} "
            f"| {c['memory_s']:.3e} | {c['collective_s']:.3e} "
            f"| {c['dominant']} | {c['useful_ratio']:.2f} "
            f"| {c['mfu_vs_model_flops']*100:.1f}% "
            f"| {'Y' if c.get('fits_card') else 'N'} |")
    return "\n".join(rows)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    cells = load_cells(args.tag, args.out_dir)
    print(table(cells))
    for c in cells:
        if c.get("status") == "ok":
            print(f"- {c['arch']} x {c['shape']}: {suggestion(c)}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(cells, f, indent=1, default=str)


if __name__ == "__main__":
    main()
