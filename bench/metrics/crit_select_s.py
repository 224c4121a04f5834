"""`crit_select_s`: device seconds per diagram of every dimension's
``GradientField.critical_sids`` (the ``nonzero`` over its dense sid
space), the ``extract_sort.select`` sub-spans of the program's
``StageReport`` summed (CUDA events, resolved at the extraction stage's
synchronize)."""

from bench.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, "extract_sort.select")
