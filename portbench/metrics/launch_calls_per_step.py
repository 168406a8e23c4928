"""launch_calls_per_step (calls, profiler): the host's kernel and graph
launch calls (cudaLaunchKernel, cudaLaunchKernelEx*, cudaGraphLaunch)
over the traced replays, reset and staging included, per step: a chunk
on the device driver, a lockstep step on the farm, whose tail round
counts as one more step."""


def read(ctx):
    if ctx.trace is None or not ctx.on_card or not ctx.traced_steps:
        return None
    return ctx.trace.launches / ctx.traced_steps
