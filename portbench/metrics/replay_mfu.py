"""replay_mfu (%, host clock and the model's widths): the int8
operations of the inferences the window served (2 x the model's
multiply-accumulates each) over the window's time, as a share of the
card's int8 peak."""

from portbench import yardstick


def read(ctx):
    if not ctx.on_card:
        return None
    ops = 2.0 * yardstick.macs_per_inference(ctx.config) \
        * sum(r.inferences for r in ctx.window)
    return 100.0 * ops / ctx.window_s / yardstick.INT8_OPS_PER_S
