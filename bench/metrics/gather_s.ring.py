"""`gather_s.ring`: seconds of ``run_front``'s ``gather`` step per call,
from the ``resolution`` step's end to the return (the replicated
reductions, the gather of every block's outputs to every rank, the
``crit_peak`` read), on rank 0 (host clock to a synchronize)."""

from bench.layers import step_mean


def read(ctx):
    return step_mean(ctx, "gather")
