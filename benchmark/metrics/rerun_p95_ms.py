"""The 95th percentile (linear interpolation) of the wall times of every
rerun of the window, in ms."""

import numpy as np


def read(ctx):
    if ctx.kind != "rerun" or not ctx.jobs:
        return None
    return float(np.percentile([j.wall for j in ctx.jobs], 95)) * 1e3
