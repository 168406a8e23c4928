"""int8_gemm_roofline (%, profiler and the step's shapes): the least
time of the INT8 GEMMs a step needs (each the larger of its bytes over
HBM bandwidth and 2MNK over the int8 peak, at the lanes a step serves)
over their kernel time, on the traced replays' graph launches that hold
every GEMM of a step."""

from portbench import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.on_card:
        return None
    lanes = yardstick.lanes_per_step(ctx.mix)
    full = ctx.trace.full_units(
        lambda name: "int8_gemm" in name,
        len(yardstick.gemm_shapes(ctx.config, lanes)))
    if not full:
        return None
    bound = yardstick.step_gemm_bound_s(ctx.config, lanes)
    return 100.0 * bound * len(full) / sum(full)
