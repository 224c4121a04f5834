"""`sort_s.ring`: seconds of ``run_front``'s ``order`` step per call, the
distributed sample sort (``distributed/order.py``), on rank 0 (host
clock to a synchronize at the step's end, in the traced run)."""

from bench.layers import step_mean


def read(ctx):
    return step_mean(ctx, "order")
