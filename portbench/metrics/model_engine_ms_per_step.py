"""model_engine_ms_per_step (ms, the program's device probes): the
Model Engine's INT8 inference a step, over the telemetry replays of
``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_step_ms(ctx, ("infer",))
