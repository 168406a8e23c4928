"""train_windows_per_s (windows/s, host clock): the feature windows
trained in the window (its steps times the batch) over the window's
whole time, the resets between jobs included."""


def read(ctx):
    return ctx.windows / ctx.window_s
