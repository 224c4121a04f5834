"""`idle_share.ring`: percent of a ring run's traced window with no
kernel, copy or set on rank 0's card (profiler)."""

from bench.layers import idle_share


def read(ctx):
    return idle_share(ctx, "ring")
