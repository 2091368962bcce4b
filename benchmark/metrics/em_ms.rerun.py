"""Mean of a rerun's ``timings["em"]`` (the EM driver and its kernel, to
the rates' copy back), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "rerun", "em")
