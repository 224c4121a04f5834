"""Distributed global vertex order — the paper's *Array Preconditioning*
(Sec. III), built on a sample sort.

PyTorch counterpart of ``repro.distributed.order``, over a block ring
(:mod:`.comm`; every tensor has the leading block axis):

  1. sort locally by (value, gid);
  2. regular-sample splitters, all_gather, select global quantile splitters;
  3. bucket by splitter, fixed-capacity all_to_all exchange;
  4. local sort of received keys; global rank = exclusive scan of bucket
     counts (all_gather) + local position;
  5. route ranks back to the owning block (second all_to_all) and restore
     the original layout.

Fixed capacity: buckets are padded to ``percap = ceil(slack * n_local /
n_blocks)`` entries; an overflow flag is returned, never silent.  A
smooth field can send most of one z-slab's keys to one bucket, so such
fields need a larger ``slack``; ``stats`` reports the largest bucket.

``rankfree_keys`` is the zero-communication alternative: (value, gid)
packed into one monotone int64 key per vertex.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .comm import Ring

_INT64_MAX = int(np.iinfo(np.int64).max)


def _sortable(f: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> int64 map (IEEE754 sign-magnitude fold)."""
    fi = f.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(fi < 0, -(fi + 2 ** 31), fi)


def rankfree_keys(f: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Monotone int64 keys equivalent to the global order, no comm:
    ``((sortable(f) + 2^31) << 31) | gid`` (nv < 2^31).  The bias keeps
    every key non-negative, above the kernels' -1 outside-the-grid
    sentinel."""
    return ((_sortable(f) + 2 ** 31) << 31) | gids.to(torch.int64)


def _positions(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Position of each entry among the entries of its row with the same
    ``key`` (0..n_blocks-1), in index order; ``counts`` (Bl, n_blocks) are
    the per-key counts."""
    Bl, n = key.shape
    perm = torch.argsort(key, dim=1, stable=True)
    pos = torch.empty_like(perm)
    pos.scatter_(1, perm, torch.arange(n, device=key.device).expand(Bl, n))
    first = torch.cumsum(counts, 1) - counts
    safe = key.clamp(max=counts.shape[1] - 1)
    return pos - torch.gather(first, 1, safe)


def _bucket_counts(key: torch.Tensor, valid: torch.Tensor,
                   n_blocks: int) -> torch.Tensor:
    counts = torch.zeros((key.shape[0], n_blocks + 1), dtype=torch.int64,
                         device=key.device)
    counts.scatter_add_(1, torch.where(valid, key, n_blocks),
                        torch.ones_like(key))
    return counts[:, :n_blocks]


def _route(payload: torch.Tensor, dest: torch.Tensor, slot: torch.Tensor,
           n_blocks: int, percap: int, fill: int) -> torch.Tensor:
    """(Bl, n_blocks, percap, W) send buffer: ``payload`` (Bl, n, W) at
    [dest, slot]; slot ``percap`` is a dump, dropped before the send."""
    Bl, n, W = payload.shape
    send = torch.full((Bl, n_blocks, percap + 1, W), fill,
                      dtype=payload.dtype, device=payload.device)
    b = torch.arange(Bl, device=payload.device)[:, None].expand(Bl, n)
    send[b, dest, slot] = payload
    return send[:, :, :percap]


def sample_sort_ranks(f_local: torch.Tensor, gid_local: torch.Tensor,
                      ring: Ring, n_blocks: int, slack: float = 2.0,
                      stats: Optional[dict] = None):
    """Global dense ranks of (f, gid) keys.  ``f_local``, ``gid_local``:
    (Bl, n_local).  Returns (ranks (Bl, n_local) int64, overflow (Bl,)
    bool, the same on every block).  ``stats`` receives ``sort_percap``
    and ``sort_bucket_peak`` (largest bucket over both exchanges)."""
    Bl, n_local = f_local.shape
    dev = f_local.device
    nb = n_blocks
    cap = int(np.ceil(slack * n_local / n_blocks)) * n_blocks
    percap = cap // nb
    key = (_sortable(f_local) << 32) | gid_local.to(torch.int64)

    # 1. local sort
    skey = torch.sort(key, dim=1).values

    # 2. splitters: n_blocks - 1 regular samples per block
    ar = torch.arange(1, nb, device=dev)
    samples = skey[:, (ar * n_local) // nb]
    all_samples = torch.sort(ring.all_gather(samples).reshape(Bl, -1),
                             dim=1).values
    m = all_samples.shape[1]
    splitters = all_samples[:, (ar * m) // nb].contiguous()

    # 3. bucketize + fixed-capacity all_to_all; skey is sorted, so each
    # bucket is a contiguous run and a position is an offset into it
    bucket = torch.searchsorted(splitters, skey, right=True)
    ones = torch.ones_like(bucket, dtype=torch.bool)
    counts = _bucket_counts(bucket, ones, nb)
    within = torch.arange(n_local, device=dev) - torch.gather(
        torch.cumsum(counts, 1) - counts, 1, bucket)
    overflow = (counts > percap).any(1)
    slot = torch.where(within < percap, within, percap)
    send = _route(torch.stack([skey, torch.ones_like(skey)], -1), bucket,
                  slot, nb, percap, 0)
    recv = ring.all_to_all(send).reshape(Bl, cap, 2)

    # 4. local sort of received keys + global offset
    valid = recv[..., 1] == 1
    rk = torch.sort(torch.where(valid, recv[..., 0], _INT64_MAX),
                    dim=1).values
    n_here = valid.sum(1)
    sizes = ring.all_gather(n_here)                        # (Bl, nb)
    me = ring.blocks()
    offset = torch.where(torch.arange(nb, device=dev)[None] < me[:, None],
                         sizes, 0).sum(1)
    ranks_here = offset[:, None] + torch.arange(cap, device=dev)

    # 5. route (gid, rank) back to the owners (owner = gid // n_local)
    gid_back = rk & 0xFFFFFFFF
    valid2 = torch.arange(cap, device=dev)[None] < n_here[:, None]
    owner = torch.where(valid2, gid_back // n_local, 0)
    counts2 = _bucket_counts(owner, valid2, nb)
    within2 = _positions(torch.where(valid2, owner, nb), counts2)
    overflow = overflow | (counts2 > percap).any(1)
    slot2 = torch.where(valid2 & (within2 >= 0) & (within2 < percap),
                        within2, percap)
    payload = torch.where(valid2[..., None],
                          torch.stack([gid_back, ranks_here], -1), -1)
    recv2 = ring.all_to_all(_route(payload, owner, slot2, nb, percap,
                                   -1)).reshape(Bl, cap, 2)

    ok = recv2[..., 0] >= 0
    local_idx = torch.where(ok, recv2[..., 0] % n_local, n_local)
    ranks = torch.zeros((Bl, n_local + 1), dtype=torch.int64, device=dev)
    ranks.scatter_(1, local_idx, torch.where(ok, recv2[..., 1], 0))
    overflow = ring.psum(overflow.to(torch.int32)) > 0
    if stats is not None:
        peak = ring.pmax(torch.maximum(counts.amax(1), counts2.amax(1)))
        stats.update(sort_percap=percap, sort_slack=slack,
                     sort_bucket_peak=int(peak[0]),
                     sort_buffer_bytes=2 * 2 * Bl * nb * (percap + 1) * 2 * 8)
    return ranks[:, :n_local], overflow
