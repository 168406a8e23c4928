"""setup_s (s, host clock): process start to the first timed unit of
the window (a replay, or a training step): imports, the inputs and
weights made from the seed, the system under test built, and its
warm-up: in a replay cell the kernel library's load (its build on a
checkout's first run) and one replay of each capture (the first
captures the step graphs); in a training cell one whole job (its first
step captures the step graph)."""


def read(ctx):
    return ctx.setup_s
