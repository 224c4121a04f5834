"""`idle_share.diagram`: percent of a diagram run's traced window with no
kernel, copy or set on the card (profiler)."""

from bench.layers import idle_share


def read(ctx):
    return idle_share(ctx, "pipeline")
