"""Driver: run the single-card dry-run matrix and persist JSON
incrementally; the port of ``repro/launch/run_all_dryruns.py``.

Per (arch x shape) cell:
  proof run   — the step traced at full depth on meta tensors
                (``launch/dryrun.py``): memory, and whether it fits the
                card.
  cost runs   — two traces at reduced depths (``cost_points``); traced
                FLOPs and bytes are affine in the layer count, so the
                full-depth values are the two-point extrapolation (exact
                for homogeneous stacks).  A full-depth trace can take long
                (``layers._band_attention`` runs a Python loop over
                sequences and bands, whose trip count grows with batch x
                sequence), which the reduced depths keep short.

Each dry run executes in its own subprocess, under a timeout.  Results
go under ``--out-dir`` (default ``dryrun_results/`` at the repository's
root, ignored by git), one directory a ``--tag``; ``launch/roofline.py``
reads them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.run_all_dryruns \\
      [--only arch[,arch]] [--shapes s1,s2] [--meshes card] \\
      [--skip-existing] [--tag baseline] [--set k=v ...] [--reduced] \\
      [--out-dir DIR]

``--meshes`` other than ``card`` and any ``--rule`` are refused, as the
port's ``launch/dryrun.py`` refuses ``--mesh`` and ``--rule``: the TPU
pod meshes and their sharding rules have no one-card counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import shape_applicable
from repro_torch.launch.mesh import check_card_mesh

RESULTS_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__),
                                            "../../../dryrun_results"))


def cost_points(arch: str, reduced: bool = False
                ) -> Tuple[List[Dict[str, str]], List[float], float]:
    """Returns ([overrides_point1, overrides_point2], [x1, x2], x_full)
    for the config of ``arch`` (its ``reduced()`` widths with
    ``reduced``)."""
    return cost_points_of(get_config(arch, reduced=reduced))


def cost_points_of(cfg) -> Tuple[List[Dict[str, str]], List[float], float]:
    """``cost_points`` of a config."""
    if cfg.family == "transformer":
        nf = cfg.moe.first_dense_layers if cfg.moe.num_experts else 0
        return ([{"num_layers": str(nf + 2)}, {"num_layers": str(nf + 4)}],
                [2.0, 4.0], float(cfg.num_layers - nf))
    if cfg.family == "ssm":
        return ([{"num_layers": "2"}, {"num_layers": "4"}],
                [2.0, 4.0], float(cfg.num_layers))
    if cfg.family == "hybrid":
        pat = len(cfg.hybrid.pattern)
        tail = cfg.num_layers % pat
        return ([{"num_layers": str(pat + tail)},
                 {"num_layers": str(2 * pat + tail)}],
                [1.0, 2.0], float(cfg.num_layers // pat))
    if cfg.family == "encdec":
        return ([{"num_encoder_layers": "2", "num_decoder_layers": "2"},
                 {"num_encoder_layers": "4", "num_decoder_layers": "4"}],
                [2.0, 4.0], float(cfg.num_encoder_layers))
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        return ([{"num_layers": str(per)}, {"num_layers": str(2 * per)}],
                [1.0, 2.0], float(cfg.num_layers // per))
    raise ValueError(cfg.family)


def run_dryrun(arch: str, shape: str, mesh: str, sets: Dict[str, str],
               rules: List[str], out: str, timeout: int = 3600, *,
               reduced: bool = False) -> Dict:
    """One dry run (``launch/dryrun.py``) in a subprocess, in the
    reference's order.  ``mesh`` must be "card" and ``rules`` empty
    (``mesh.check_card_mesh``): checked before anything starts."""
    check_card_mesh(mesh, rules)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out]
    for k, v in sets.items():
        cmd += ["--set", f"{k}={v}"]
    if reduced:
        cmd.append("--reduced")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "../..")
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "arch": arch, "shape": shape,
                "mesh": mesh}
    if p.returncode != 0:
        return {"status": "error", "arch": arch, "shape": shape,
                "mesh": mesh, "stderr": p.stderr[-4000:],
                "wall_s": round(time.time() - t0, 1)}
    with open(out) as f:
        return json.load(f)


def extrapolate(p1: Dict, p2: Dict, x1: float, x2: float,
                x_full: float) -> Dict:
    def ex(a, b):
        return a + (b - a) / (x2 - x1) * (x_full - x1)

    out = {"points": [x1, x2], "x_full": x_full}
    c1, c2 = p1.get("cost", {}), p2.get("cost", {})
    for k in ("flops", "bytes_accessed", "transcendentals"):
        if k in c1 and k in c2:
            out[k] = ex(c1[k], c2[k])
    ob1, ob2 = p1.get("op_bytes", {}), p2.get("op_bytes", {})
    if ob1 and ob2:
        # the reference's CPU-backend artifact bytes (HLO ``convert`` and
        # ``copy``); the port's histogram is by aten op and has neither
        # key, so nothing is taken off: its casts and copies are traffic
        # the card moves
        def artifact(ob):
            return 1.5 * ob.get("convert", 0.0) + 2.0 * ob.get("copy", 0.0)
        art = ex(artifact(ob1), artifact(ob2))
        out["artifact_bytes"] = art
        if "bytes_accessed" in out:
            out["adj_bytes_accessed"] = max(out["bytes_accessed"] - art,
                                            0.0)
        out["op_bytes_points"] = [ob1, ob2]
    col1 = p1.get("collectives", {})
    col2 = p2.get("collectives", {})
    if "total_bytes" in col1 and "total_bytes" in col2:
        out["collective_bytes"] = ex(col1["total_bytes"],
                                     col2["total_bytes"])
        per = {}
        ops = set(col1.get("per_op", {})) | set(col2.get("per_op", {}))
        for op in ops:
            b1 = col1.get("per_op", {}).get(op, {}).get("bytes", 0.0)
            b2 = col2.get("per_op", {}).get(op, {}).get("bytes", 0.0)
            per[op] = ex(b1, b2)
        out["collective_bytes_per_op"] = per
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--meshes", default="card",
                    help="card (the TPU pod meshes have no counterpart)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-proof", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--rule", action="append", default=[],
                    help="not on one card: no mesh to shard over")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced() widths")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    try:
        for mesh in args.meshes.split(","):
            check_card_mesh(mesh, args.rule)
    except ValueError as err:
        ap.error(str(err))

    archs = args.only.split(",") if args.only else list(list_archs())
    shapes = args.shapes.split(",") if args.shapes else list(SHAPES)
    extra_sets = dict(s.split("=", 1) for s in args.set)
    tagdir = os.path.join(args.out_dir, args.tag)
    os.makedirs(tagdir, exist_ok=True)

    for arch in archs:
        cfg = get_config(arch, reduced=args.reduced)
        for shape in shapes:
            ok, reason = shape_applicable(cfg, SHAPES[shape])
            if not ok:
                path = os.path.join(tagdir, f"skip_{arch}_{shape}.json")
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "status": "skipped", "reason": reason}, f)
                print(f"[skip ] {arch} x {shape}: {reason}", flush=True)
                continue
            # ---- proof run: the whole depth, on the card's mesh of one
            if not args.no_proof:
                out = os.path.join(tagdir, f"proof_{arch}_{shape}_card.json")
                if not (args.skip_existing and os.path.exists(out)):
                    t0 = time.time()
                    res = run_dryrun(arch, shape, "card", dict(extra_sets),
                                     [], out, reduced=args.reduced)
                    with open(out, "w") as f:
                        json.dump(res, f, indent=1, default=str)
                    print(f"[proof] {arch} x {shape} x card: "
                          f"{res.get('status')} ({time.time()-t0:.0f}s)",
                          flush=True)
            # ---- cost runs: two reduced depths, unrolled, extrapolated
            if not args.no_cost:
                out = os.path.join(tagdir, f"cost_{arch}_{shape}.json")
                if args.skip_existing and os.path.exists(out):
                    continue
                points, xs, x_full = cost_points(arch, args.reduced)
                results = []
                failed = False
                for i, ov in enumerate(points):
                    sets = {"scan_layers": "false", **ov, **extra_sets}
                    pth = os.path.join(tagdir,
                                       f".pt{i}_{arch}_{shape}.json")
                    t0 = time.time()
                    res = run_dryrun(arch, shape, "card", sets, [], pth,
                                     reduced=args.reduced)
                    results.append(res)
                    print(f"[cost{i}] {arch} x {shape}: "
                          f"{res.get('status')} ({time.time()-t0:.0f}s)",
                          flush=True)
                    if res.get("status") != "ok":
                        failed = True
                        break
                if not failed:
                    final = extrapolate(results[0], results[1], xs[0], xs[1],
                                        x_full)
                    final.update({"arch": arch, "shape": shape,
                                  "status": "ok",
                                  "point_results": results})
                else:
                    final = {"arch": arch, "shape": shape, "status": "error",
                             "point_results": results}
                with open(out, "w") as f:
                    json.dump(final, f, indent=1, default=str)


if __name__ == "__main__":
    main()
