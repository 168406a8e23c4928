"""train_idle_share (%, profiler and host clock): 1 - the device's busy
time over the traced steps / the wall time of the same steps of a job
as the window ran them, timed without the profiler (each step's median
over the window's jobs)."""


def read(ctx):
    busy, wall = ctx.device.get("busy_s"), ctx.device.get("window_s")
    if not busy or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)
