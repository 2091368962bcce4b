"""Mean of a first-pass job's ``timings["join_bin"]`` (the native scan of
the two ``.colate.in`` files, the join and the analytic binning, inside
``parse``), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "first_pass", "join_bin")
