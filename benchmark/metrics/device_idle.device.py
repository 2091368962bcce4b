"""Share of the traced window in which nothing ran on the card: 1 - the
union of the intervals of the device operations / the window, in %."""

from benchmark.metrics._means import idle_share


def read(ctx):
    return idle_share(ctx, "first_pass")
