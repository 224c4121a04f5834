"""`d0_host_syncs`: the times per diagram that D0's pointer-jumping
fixpoint waits on the card for a host read (each jump's ``any``, each
round's ``torch.equal``s), the program's ``d0_host_syncs`` counter on
the D0 stage's ``StageReport``."""

from bench.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, "d0_host_syncs")
