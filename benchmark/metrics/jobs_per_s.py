"""Whole jobs per second of the window: every job the window completed
with its ``.coal`` written, over the window, which ends at a completion."""


def read(ctx):
    return sum(j.ok for j in ctx.jobs) / ctx.window_s
