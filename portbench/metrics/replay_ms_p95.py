"""replay_ms_p95 (ms, host clock): the 95th percentile of the wall
times of every replay in the window (linear interpolation)."""

import numpy as np


def read(ctx):
    return float(np.percentile([r.seconds for r in ctx.window], 95)) * 1e3
