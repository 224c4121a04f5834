"""Faults planted underneath a ring run, one per ``rank_hook``: each is
called with the rank in every rank's process before the run starts."""


def no_exchange(rank):
    """The ring's shifts move nothing between ranks: every edge block a
    rank should receive from a neighbour comes in as zeros."""
    from repro_torch.distributed import comm

    def shift_async(self, x, up, wrap=False):
        import torch
        out = torch.roll(x, 1 if up else -1, dims=0)
        out[0 if up else -1] = 0
        return lambda: out
    comm.GroupRing.shift_async = shift_async


def altered_answer(rank):
    """Rank 1's first block pairs its first vertex with another edge,
    where the block's rows are made; the gather then carries it to
    every rank."""
    from repro_torch.distributed import shardmap_pipeline as sp
    orig = sp.front_device_fn

    def altered(cfg, ring, f_slab, stats=None):
        out = orig(cfg, ring, f_slab, stats)
        if rank == 1:
            out["vpart"] = out["vpart"].clone()
            out["vpart"][0, 0] = (out["vpart"][0, 0] + 1) % 14
        return out
    sp.front_device_fn = altered


def one_rank_differs(rank):
    """Rank 2's copy of the gathered outputs has one D0 end changed after
    the gather: its answer is not rank 0's."""
    import repro_torch.distributed as d
    orig = d.run_front

    def altered(*a, **kw):
        cfg, out = orig(*a, **kw)
        if rank == 2:
            out["d0_t0"] = out["d0_t0"].clone()
            out["d0_t0"][0] += 1
        return cfg, out
    d.run_front = altered
