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

For a ``train`` cell (``train_readings``) each seed's set-up is a run's:
its windows and initial weights, the program's trainer and one warm-up
job; then one job as the window runs it, and the plain reference over
the same rows.  Each side reads ``check_train``'s numbers and, over the
whole job, ``job_loss_gap`` (every step's loss) and ``final_*_gap`` (by
the worst leaf, the norm of the leaves and of both moments after the
last step), which the runs do not compare:

* the control: the program with TF32 matmuls on
  (``torch.backends.cuda.matmul.allow_tf32``), the precision below the
  float32 the mix states, set in this process alone;
* with ``--program``, the program as the runs run it;
* with ``--faults``, each of ``train_ref.FAULTS`` planted in the
  reference put in the program's place, over the first ``KEEP`` steps;
* with ``--witness``, the reference on the CPU (another reduction
  order), over the first ``KEEP`` steps.

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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, check_train, harness, inputs  # noqa: E402
from portbench.reference import fenix_ref, train_ref  # noqa: E402
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


def _program_job(cell, seed: int, dev, data, init) -> dict:
    """The program's job 1 after its warm-up job 0, as a run's window
    runs it: its losses, snapshots and final leaves and moments."""
    from portbench.runners import train as tr

    trainer = tr.build_trainer(cell, init, dev)
    feed = tr.Feed({k: torch.from_numpy(a).to(dev) for k, a in
                    data.items()}, int(cell.mix["batch"]))
    snap = tr.Snapshots(trainer)
    init_l = list(init.values())
    tr.run_job(trainer, feed, snap, init_l, seed, 0)
    job = tr.run_job(trainer, feed, snap, init_l, seed, 1)
    out = {"losses": job.losses, **snap.on_host(),
           "final": {part: {k: v.to("cpu", copy=True)
                            for k, v in tree.items()} for part, tree in
                     (("params", trainer.params),
                      ("m", trainer.opt_state["m"]),
                      ("v", trainer.opt_state["v"]))}}
    del trainer, feed, snap
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _job_rows(cell, seed: int, n: int, job: int = 1):
    from portbench.runners import train as tr

    feed = tr.Feed({"label": torch.empty(n)}, int(cell.mix["batch"]))
    feed.start(seed, job)
    return [next(feed)["index"] for _ in range(int(cell.mix["job_steps"]))]


def _train_numbers(got: dict, ref: dict, init, b1: float) -> dict:
    nums = check_train.compare(got, ref, init, b1)
    if len(got["losses"]) == len(ref["losses"]):    # a whole job
        lp = np.asarray(got["losses"], np.float64)
        lr = np.asarray(ref["losses"], np.float64)
        nums["job_loss_gap"] = float(np.max(np.abs(lp - lr) / np.abs(lr)))
        for part in ("params", "m", "v"):
            nums[f"final_{part}_gap"] = check_train._worst_leaf(
                check_train._norms(got["final"][part]),
                check_train._norms(ref["final"][part]))
    return nums


def train_readings(cell, seed: int, dev, program: bool, faults: bool,
                   witness: bool):
    """{side: numbers} for one seed of a ``train`` cell."""
    x, y, w = inputs.make_training_windows(cell.mix, seed,
                                           cell.config["seq_len"])
    data = {"payload": x, "label": y, "weight": w}
    init = inputs.make_float_params(cell.config, seed, dev)
    init_cpu = {k: v.to("cpu", copy=True) for k, v in init.items()}
    b1 = float(cell.mix["b1"])
    rows = _job_rows(cell, seed, len(y))
    sides = {}
    if program:
        sides["program"] = _program_job(cell, seed, dev, data, init)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sides["control"] = _program_job(cell, seed, dev, data, init)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del init
    ref = train_ref.run_job(cell.config, cell.mix, data, init_cpu, rows,
                            dev, check_train.KEEP)
    keep = rows[:check_train.KEEP]
    for f in train_ref.FAULTS if faults else ():
        sides[f"fault:{f}"] = train_ref.run_job(
            cell.config, cell.mix, data, init_cpu, keep, dev,
            check_train.KEEP, fault=f)
    if witness:
        sides["reference_cpu"] = train_ref.run_job(
            cell.config, cell.mix, data, init_cpu, keep, "cpu",
            check_train.KEEP)
    for side, got in sides.items():
        if "m1" not in got:         # a reference's: its step-1 gradient
            got["m1"] = {k: g * (1.0 - b1) for k, g in got["grad1"].items()}
    return {side: _train_numbers(got, ref, init_cpu, b1)
            for side, got in sides.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = harness.resolve(args.workload)
    dev = torch.device(args.device)
    train = cell.mix["kind"] == "train"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = (train_readings(cell, seed, dev, args.program, args.faults,
                              args.witness) if train
               else readings(cell, seed, dev, args.program))
        for side, nums in out.items():
            ok = (check_train.verdict_of(nums) if train
                  else check.verdict_of(nums))
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side, "numbers": nums,
                              "correct": ok,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
