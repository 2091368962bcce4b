"""Mean of a rerun's ``timings["coal_write"]`` (the write of its
``.coal``), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "rerun", "coal_write")
