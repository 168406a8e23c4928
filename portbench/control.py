"""The comparison's two readings at a cell's own size, many seeds in one
process:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--program]

For each seed it makes the cell's captures and weights, replays every
capture through the plain reference, and compares with it, by
``check.compare``:

* the control: the same reference with its weights on the int4 grid,
  the precision below the configuration's int8, in the program's place
  (its numbers must fail the limits);
* with ``--program``, the program itself (warm-up and one replay of
  each capture on the cell's driver, as a run's window replays them):
  the lower readings the limits sit above.

One JSON line a seed and side.  The benchmark's own runs do not run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from portbench import check, harness, inputs  # noqa: E402
from portbench.reference import fenix_ref  # noqa: E402
from portbench.reference.model_ref import ModelRef  # noqa: E402


def readings(cell, seed: int, dev, program: bool):
    """{side: numbers} for one seed: "control" and, with ``program``,
    "program"."""
    from portbench.runners import replay as rp

    caps = inputs.make_captures(cell.mix, seed)
    streams = [inputs.stream_of(c) for c in caps]
    qp = inputs.make_weights(cell.config, seed, caps[0]["windows"], dev)
    lay = fenix_ref.layout_of(cell.mix)
    out = {}
    if program:
        system = rp.build_system(cell, qp, dev)
        for s in streams:
            rp.replay_once(system, s)
        last, digests = {}, []
        for k, s in enumerate(streams):
            v, _ = rp.replay_once(system, s)
            last[k] = (v, system.stats)
            digests.append((k, check.digest(v, system.stats)))
        carry = (len(streams) - 1, rp.final_carry(system))
        del system
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    refs = {k: fenix_ref.replay(s, lay, ModelRef(cell.config, qp, dev), dev)
            for k, s in enumerate(streams)}
    if program:
        out["program"] = check.compare(last, digests, carry, refs)[0]
    low = ModelRef(cell.config, qp, dev, weight_bits=4)
    ctl = {k: fenix_ref.replay(s, lay, low, dev)
           for k, s in enumerate(streams)}
    out["control"] = check.compare(
        {k: (r["verdict"], r["stats"]) for k, r in ctl.items()},
        [(k, check.digest(r["verdict"], r["stats"])) for k, r in
         ctl.items()],
        (len(streams) - 1, ctl[len(streams) - 1]["carry"]), refs)[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = harness.resolve(args.workload)
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for side, nums in readings(cell, seed, dev, args.program).items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side, "numbers": nums,
                              "correct": check.verdict_of(nums),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
