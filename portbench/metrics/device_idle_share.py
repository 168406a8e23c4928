"""device_idle_share (%, profiler and host clock): 1 - the device's
busy time over the traced replays / the wall time of the same captures'
replays in the window, timed without the profiler (which stretches a
replay's wall, not its device work)."""


def read(ctx):
    busy, wall = ctx.device.get("busy_s"), ctx.device.get("window_s")
    if not busy or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)
