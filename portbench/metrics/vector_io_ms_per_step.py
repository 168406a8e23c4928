"""vector_io_ms_per_step (ms, the program's device probes): Vector I/O
and the delay line a step: the delay line's delivery (with the chunk's
copy in and unpacking), the ring enqueue (with the switch tree and the
chunk's counts), the service budget and dequeue (on the farm, the
engine router too) and the delay-line push, over the telemetry replays
of ``portbench/probes.py``."""

from portbench import probes


def read(ctx):
    return probes.per_step_ms(ctx, ("deliver", "enqueue_ring", "dequeue",
                                    "push"))
