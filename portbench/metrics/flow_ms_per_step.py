"""flow_ms_per_step (ms, the program's device probes): the Data
Engine's flow stage a step (the five-tuple hash, the slots, first
occurrences, running counts and backlog gathers), over the telemetry
replays of ``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_step_ms(ctx, ("flow",))
