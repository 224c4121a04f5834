"""`edge_keys_s`: device seconds per diagram of ``edge_keys_kernel``, the
dense packed key of every edge sid, the ``extract_sort.edge_keys``
sub-span of the program's ``StageReport`` (CUDA events, resolved at the
extraction stage's synchronize)."""

from bench.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, "extract_sort.edge_keys")
