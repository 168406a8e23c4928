"""draw_ms_per_step (ms, the program's device probes): the Data
Engine's threefry stage a step (the key split and the gate's random
draws; the split alone where the gate draws its own), over the
telemetry replays of ``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_step_ms(ctx, ("draw",))
