"""table_ms_per_step (ms, the program's device probes): the Data
Engine's table stage a step (features, the feature-ring gather and the
flow-table writes), over the telemetry replays of
``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_step_ms(ctx, ("table",))
