"""fused_gate_roofline (%, profiler and the step's lanes): the fused
admission gate's bytes bound over [pipes, batch] lanes (each lane's
four int32 inputs and one byte out, each pipe's LUT and registers) over
its kernel time, on the traced replays' graph launches that hold the
step's one gate kernel."""

from portbench import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.on_card:
        return None
    full = ctx.trace.full_units(lambda name: "fused_gate" in name, 1)
    if not full:
        return None
    bound = yardstick.gate_bound_s(int(ctx.mix.get("num_pipes", 1)),
                                   int(ctx.mix["batch_size"]))
    return 100.0 * bound * len(full) / sum(full)
