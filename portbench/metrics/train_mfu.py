"""train_mfu (%, host clock and the model's widths): the float
operations the window's training needed (3 x 2 x the model's
multiply-accumulates a window: the forward pass, and the backward pass
at twice its cost) over the window's time, as a share of the card's
float32 peak.  The program trains in full float32: nothing in it turns
TF32 on, so its matmuls run on the CUDA cores, whose peak this is."""

from portbench import yardstick


def read(ctx):
    if not ctx.on_card:
        return None
    ops = yardstick.train_flops_per_window(ctx.config) * ctx.windows
    return 100.0 * ops / ctx.window_s / yardstick.FP32_FLOPS_PER_S
