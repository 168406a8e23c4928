"""device_gap_ms_per_replay (ms, the program's device probes): the time
the device sat idle between a replay's own device spans (reset, staging,
the buffers' load, each chunk, the finish), read by the probes without
a profiler, the mean over the telemetry replays of
``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_replay_ms(ctx,
                                lambda r: r["device"]["gap_ns"] / 1e6)
