"""Mean of a first-pass job's ``timings["join"]`` (the staged route's
native ``join_tmptmp`` of the decoded streams and tables, inside
``parse``), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "first_pass", "join")
