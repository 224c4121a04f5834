"""`resolve_s.ring`: seconds of ``run_front``'s ``successors``,
``emission`` and ``resolution`` steps per call (the tet table, the
triplet buffers and ``ring_resolve`` around the ring), on rank 0."""

from bench.layers import step_mean


def read(ctx):
    return step_mean(ctx, "successors", "emission", "resolution")
