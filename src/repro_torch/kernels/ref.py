"""Plain PyTorch version of the lower-star gradient pairing.

The masked-recomputation form of ProcessLowerStars, as
``repro.kernels.ref.lower_star_gradient_jnp`` states it: priority queues
become masked lexicographic argmins over a fixed 74-row table, all
vertices advance in lock-step, and a per-vertex ``done`` mask retires
finished lanes.  It is what the CUDA kernels of ``kernels.lower_star``
compute, and what their wrappers run for tensors on the CPU.

Two key representations, chosen by ``rank_bound`` (the exclusive upper
bound on vertex ranks, i.e. ``grid.nv``):

- **packed** (``rank_bound < 2**21``): the 3-element descending key packs
  into one int64 word (21 bits per element, +1 bias so -1 maps to 0); each
  vertex's rows are ranked once by that key, and every pop is an int8 min
  over those priority ranks;
- **columns** (no bound, or ``rank_bound >= 2**21``): the (n, 74, 3) key
  table with a three-pass lexicographic argmin.

Both give identical rows: pops only ever select lower-star rows, whose
keys are distinct.  :func:`local_rank_keys` is the plain form of the CUDA
kernels' keys (each neighbour replaced by its rank among the vertex's
lower neighbours, three 4-bit fields).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gradient as GR
from repro_torch.core import grid as G

R = GR.NROWS                     # 74 packed star rows
EDGE_ROWS = G.NSTAR[1]           # rows [0, 14) are edges
OTH = np.asarray(GR.PACKED["others"], dtype=np.int64)   # (74,3), -1 pad
FID = np.asarray(GR.PACKED["fid"], dtype=np.int64)      # (74,3), -1 pad

NOT_L, AVAIL, TAIL, HEAD, CRIT = GR.NOT_L, GR.AVAIL, GR.TAIL, GR.HEAD, GR.CRIT

# edge row e joins the vertex to neighbour slot EDGE_NBR[e]; every row's
# other vertices are among these 14, so OTH_EDGE names them by edge
EDGE_NBR = OTH[:EDGE_ROWS, 0]
OTH_EDGE = np.where(OTH >= 0, np.argmax(OTH[..., None] == EDGE_NBR, -1), -1)

# ranks below this bound pack 3 key elements into one int64 (21 bits each)
PACK_BOUND = 1 << 21
# vertices per pass: bounds the (n, 74, 3) temporaries (~2 GB at int64)
CHUNK = 1 << 21

# calls of the plain version on CUDA tensors (the main path must show 0)
CUDA_CALLS = {"lower_star_gradient_torch": 0}


def use_packed_keys(rank_bound) -> bool:
    """Can 3-element keys pack into one int64 word?"""
    return rank_bound is not None and int(rank_bound) < PACK_BOUND


def sort3_desc(vals: torch.Tensor) -> torch.Tensor:
    """Descending 3-element sorting network along the last axis."""
    a, b, c = vals[..., 0], vals[..., 1], vals[..., 2]
    a, b = torch.maximum(a, b), torch.minimum(a, b)
    a, c = torch.maximum(a, c), torch.minimum(a, c)
    b, c = torch.maximum(b, c), torch.minimum(b, c)
    return torch.stack([a, b, c], dim=-1)


def pack_key3(k3: torch.Tensor) -> torch.Tensor:
    """Pack a (..., 3) descending key into one int64 (21 bits/element)."""
    k = k3.long() + 1
    return (k[..., 0] << 42) | (k[..., 1] << 21) | k[..., 2]


def lexmin(keys: torch.Tensor, mask: torch.Tensor, inf: int) -> torch.Tensor:
    """Index of the lexicographically smallest key row under ``mask``
    (first such row; 0 when the mask is empty).  keys (n, R, 3)."""
    m = mask
    for c in range(3):
        kc = torch.where(m, keys[..., c], inf)
        m = m & (kc == kc.min(dim=-1, keepdim=True).values)
    return m.to(torch.uint8).argmax(dim=-1)


def star_values(nbrs: torch.Tensor, ov: torch.Tensor):
    """(vals, in_l): per-row other-vertex orders (n, 74, 3), -1 in the
    padded slots, and lower-star membership (n, 74)."""
    oth = torch.as_tensor(OTH, device=nbrs.device)
    real = oth >= 0
    vals = torch.where(real, nbrs[:, oth.clamp(min=0)], -1)
    ok = (~real) | (vals >= 0)
    lower = (~real) | (vals < ov[:, None, None])
    return vals, (ok & lower).all(dim=-1)


def local_ranks(nbrs: torch.Tensor, ov: torch.Tensor) -> torch.Tensor:
    """(n, 14) int32 rank of each edge's neighbour among the vertex's lower
    neighbours (1..14), 0 when it is not lower (or outside the grid)."""
    v = nbrs[:, torch.as_tensor(EDGE_NBR, device=nbrs.device)]
    low = (v >= 0) & (v < ov[:, None])
    v = torch.where(low, v, ov[:, None])      # never below a lower value
    rk = 1 + (v[:, None, :] < v[:, :, None]).sum(-1, dtype=torch.int32)
    return torch.where(low, rk, 0)


def local_rank_keys(nbrs: torch.Tensor, ov: torch.Tensor) -> torch.Tensor:
    """(n, 74) int32 row keys of the CUDA kernels: the row's local ranks
    (:func:`local_ranks`, 0 padded; at most 14) sorted descending, as three
    4-bit fields (12 bits; the kernels keep bit j of every row's key as one
    row mask).  On lower-star rows they order like the global keys,
    whatever the rank type or magnitude."""
    oe = torch.as_tensor(OTH_EDGE, device=nbrs.device)
    vals = torch.where(oe >= 0, local_ranks(nbrs, ov)[:, oe.clamp(min=0)], 0)
    k = sort3_desc(vals)
    return (k[..., 0] << 8) | (k[..., 1] << 4) | k[..., 2]


def _onehot_set(arr, idx, value, active, rows):
    """arr (n, R); arr[i, idx[i]] = value where active[i]."""
    oh = (rows[None, :] == idx[:, None]) & active[:, None]
    return torch.where(oh, torch.as_tensor(value, dtype=arr.dtype,
                                           device=arr.device), arr)


def _pair_chunk(nbrs: torch.Tensor, ov: torch.Tensor, packed: bool):
    n = nbrs.shape[0]
    dev = nbrs.device
    inf = int(torch.iinfo(nbrs.dtype).max)
    fid = torch.as_tensor(FID, device=dev)
    fid0 = fid.clamp(min=0)
    rows = torch.arange(R, device=dev)

    vals, in_l = star_values(nbrs, ov)
    keys = sort3_desc(vals)                                   # (n,74,3)
    if packed:
        # priority ranks: each vertex's rows sorted by packed key once,
        # then every pop is an int8 min plus a one-element gather
        inv = torch.argsort(pack_key3(keys), dim=-1, stable=True)  # rank->row
        prank = torch.argsort(inv, dim=-1).to(torch.int8)          # row->rank
        none_ = 127

    def pop(mask):
        """(argmin row, any-set) under mask — one priority-queue pop."""
        if packed:
            mn = torch.where(mask, prank, none_).amin(dim=-1)
            row = torch.gather(inv, 1, mn.clamp(max=R - 1).long()[:, None])
            return row[:, 0], mn < none_
        return lexmin(keys, mask, inf), mask.any(dim=-1)

    status = torch.where(in_l, AVAIL, NOT_L).to(torch.int8)          # (n,R)
    partner = torch.full((n, R), -1, dtype=torch.int8, device=dev)

    delta, has_edge = pop((status == AVAIL) & (rows < EDGE_ROWS))
    vstat = torch.where(has_edge, TAIL, CRIT).to(torch.int8)
    vpart = torch.where(has_edge, delta, -1).to(torch.int32)
    status = _onehot_set(status, delta, HEAD, has_edge, rows)
    partner = _onehot_set(partner, delta, -2, has_edge, rows)

    while True:
        avail = status == AVAIL
        fa = (fid >= 0) & avail[:, fid0]                      # (n,74,3)
        nuf = fa.sum(dim=-1)
        alpha, any1 = pop(avail & (nuf == 1))
        fid_a = fid[alpha]                                     # (n,3)
        fa_a = (fid_a >= 0) & torch.gather(avail, 1, fid_a.clamp(min=0))
        face = torch.gather(fid_a, 1, fa_a.to(torch.uint8).argmax(
            dim=-1, keepdim=True))[:, 0]
        gamma, any0 = pop(avail & (nuf == 0))
        do1 = any1
        do0 = (~any1) & any0
        if not bool((do1 | do0).any()):
            break
        status = _onehot_set(status, alpha, HEAD, do1, rows)
        status = _onehot_set(status, face, TAIL, do1, rows)
        status = _onehot_set(status, gamma, CRIT, do0, rows)
        partner = torch.where((rows[None, :] == alpha[:, None]) & do1[:, None],
                              face[:, None].to(torch.int8), partner)
        partner = torch.where((rows[None, :] == face[:, None]) & do1[:, None],
                              alpha[:, None].to(torch.int8), partner)
    return status, partner, vstat, vpart


def lower_star_gradient_torch(nbrs: torch.Tensor, ov: torch.Tensor,
                              rank_bound: int | None = None):
    """Gradient pairing for a batch of vertices (plain PyTorch).

    nbrs: (n, 27) neighbour orders (-1 outside the grid); ov: (n,) vertex
    orders; int32 or int64.  ``rank_bound`` (exclusive upper bound on the
    ranks, ``grid.nv``) enables the packed-key path below 2**21.
    Returns (status (n,74) int8, partner (n,74) int8, vstat (n,) int8,
    vpart (n,) int32); partner -2 marks the edge paired with the vertex,
    other entries are packed row ids.  Vertices are processed in chunks
    of ``CHUNK`` (every vertex is independent)."""
    if nbrs.device.type == "cuda":
        CUDA_CALLS["lower_star_gradient_torch"] += 1
    packed = use_packed_keys(rank_bound)
    n = nbrs.shape[0]
    if n <= CHUNK:
        return _pair_chunk(nbrs, ov, packed)
    parts = [_pair_chunk(nbrs[i:i + CHUNK], ov[i:i + CHUNK], packed)
             for i in range(0, n, CHUNK)]
    return tuple(torch.cat(p) for p in zip(*parts))
