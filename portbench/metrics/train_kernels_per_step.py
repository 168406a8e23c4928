"""train_kernels_per_step (kernels, profiler): the kernels one replay of
the captured train step runs (copies and sets left out), the most that
any traced step's graph launch holds (the profiler drops a kernel's
record now and then, never adds one).  What a fused optimizer or a
fused step removes."""


def read(ctx):
    if ctx.trace is None or not ctx.on_card or not ctx.trace.units:
        return None
    return float(max(sum(1 for name, _ in ks
                         if not name.startswith(("Memcpy", "Memset")))
                     for ks in ctx.trace.units.values()))
