"""train_device_ms_per_step (ms, profiler): the device's busy time (the
union of its kernel, copy and set intervals) over the traced steps, per
step."""


def read(ctx):
    if ctx.trace is None or not ctx.on_card or not ctx.trace.busy_s:
        return None
    return ctx.trace.busy_s / ctx.traced_steps * 1e3
