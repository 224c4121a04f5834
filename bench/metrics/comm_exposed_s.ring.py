"""`comm_exposed_s.ring`: seconds per ``run_front`` call that rank 0's
compute stream waits on NCCL: the ``comm`` step, the sum of the
``GroupRing``'s ``comm.<op>`` sub-spans (CUDA events on the calling
stream from just before each collective is queued, a shift from its
wait, to just after its wait)."""

from bench.layers import step_mean


def read(ctx):
    return step_mean(ctx, "comm")
