"""`d0_graph_s`: device seconds per diagram of ``build_d0_graph``, the
``d0.graph`` sub-span of the program's ``StageReport`` (CUDA events,
resolved at the D0 stage's synchronize); the rest of ``d0_s`` is the
pointer-jumping fixpoint, ``d0.fixpoint``."""

from bench.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, "d0.graph")
