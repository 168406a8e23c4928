"""staging_ms_per_replay (ms, the program's host span): the host time
of a replay's ``stage`` span (packing the trace into chunks and
enqueueing its copies to the device), the mean over the telemetry
replays of ``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_replay_ms(ctx, lambda r: probes.span_ms(r, "stage"))
