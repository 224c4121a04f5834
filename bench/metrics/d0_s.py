"""`d0_s`: seconds of the ``d0`` stage per diagram, from the
program's ``StageReport`` (host clock to a synchronize at the stage's
end)."""

from bench.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, "d0")
