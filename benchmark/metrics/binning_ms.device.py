"""Mean of a first-pass job's ``timings["binning"]`` (the whole device
binning, from the joined sites to the histograms on the host: the
stream's layout, its copy to the card, the kernel and the copy back), in
ms."""

from benchmark.metrics._means import mean_timing


def read(ctx):
    return mean_timing(ctx, "first_pass", "binning")
