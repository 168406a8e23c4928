"""carry_store_ms_per_step (ms, the program's device probes): the
driver's store stage a step (the new carry copied into the step's
buffers, the stats summed, the verdicts copied out), over the telemetry
replays of ``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_step_ms(ctx, ("store",))
