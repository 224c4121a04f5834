"""`scatter_s`: device seconds per diagram of the scatter of the fused
kernel's rows into the ``GradientField`` (``scatter_results_batch``),
the ``gradient.scatter`` sub-span of the program's ``StageReport``
(CUDA events, resolved at the gradient stage's synchronize)."""

from bench.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, "gradient.scatter")
