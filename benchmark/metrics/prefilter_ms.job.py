"""Mean of a first-pass job's ``timings["prefilter"]`` (the native ``.mut``
parse and filter, inside ``parse``), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "first_pass", "prefilter")
