"""Mean of a rerun's ``timings["colate_mat_read"]`` (the read of its
``.colate_mat``), in ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "rerun", "colate_mat_read")
