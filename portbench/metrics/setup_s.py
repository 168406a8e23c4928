"""setup_s (s, host clock): process start to the first timed replay:
imports, the kernel library's load (its build on a checkout's first
run), the captures and weights, the system and one warm-up replay of
each capture (the first captures the step graphs)."""


def read(ctx):
    return ctx.setup_s
