"""Mean of a first-pass job's ``timings["bin_prep"]`` (the host's layout of
the site stream in page-locked memory and its chunk table, inside
``binning``), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "first_pass", "bin_prep")
