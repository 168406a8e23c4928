"""replay_pps (packets/s, host clock): every packet replayed in the
window over the window's whole time."""


def read(ctx):
    return sum(r.packets for r in ctx.window) / ctx.window_s
