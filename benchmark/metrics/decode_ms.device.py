"""Mean of a first-pass job's ``timings["decode"]`` (the staged route's
whole-file decode of the two ``.colate.in`` streams and the ``.mut``
tables, inside ``parse``), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "first_pass", "decode")
