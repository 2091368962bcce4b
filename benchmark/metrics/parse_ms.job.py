"""Mean of a first-pass job's ``timings["parse"]``, in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "first_pass", "parse")
