"""The distributed DDMS front-end over a block ring (paper Sec. III/IV).

PyTorch counterpart of ``repro.distributed.shardmap_pipeline``.  The
scalar field is z-slab decomposed into ``n_blocks`` blocks; the
per-block program (:func:`front_device_fn`) is written over a leading
block axis and talks to its neighbours through a :class:`~.comm.Ring`
(all blocks on one device with :class:`~.comm.LocalRing`, ``n_blocks /
world`` consecutive blocks per rank with :class:`~.comm.GroupRing`).
Each block:

  1. *array preconditioning*: the distributed sample sort gives global
     dense vertex ranks (:mod:`.order`), or rank-free (value, gid) keys;
  2. exchanges one boundary plane of ranks with each ring neighbour — the
     ghost layer;
  3. runs the lower-star gradient on its own vertices: the fused CUDA
     kernel's halo entry on the (nz_local+2, ny, nx) volume (``"fused"``),
     the prepass kernel (``"prepass"``) or the plain version
     (``"torch"``);
  4. builds successors by index arithmetic from the packed rows: vertex
     -> next vertex (descending v-paths), tet -> next tet (ascending dual
     paths, OMEGA at the compactified boundary); tets based in the plane
     below belong to the neighbour and their successors are shipped down;
  5. resolves the traces: local pointer doubling, then *ring resolution*,
     the boundary-plane tables rotating around the ring;
  6. emits capacity-padded triplet buffers for D0 and the dual diagram.

Every output equals the reference's array for array (padding included).
Two departures for memory at full size: the (nv_local, 27) neighbour
tensor is never built for the fused kernel (the orders at the critical
simplices are read from the halo volume, :func:`_nbr_at`), and the 24
tet rows are scattered into the tet table one at a time rather than as
one (nv_local, 24, ...) batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gradient as GR
from repro_torch.core import grid as G
from repro_torch.core.gradient import neighbor_orders
from repro_torch.core.grid import Grid
from repro_torch.kernels.lower_star import (fused_rows_from_halo_volume,
                                            halo_owned_neighbors,
                                            lower_star_gradient_prepass)
from repro_torch.kernels.ref import lower_star_gradient_torch
from repro_torch.obs import flight as _flight
from repro_torch.obs.trace import Trace, current_trace, sub_scope, \
    trace_active

from .comm import Ring, block_ring
from .order import rankfree_keys, sample_sort_ranks

OMEGA = -2
GRADIENT_BACKENDS = ("fused", "prepass", "torch")


class CritCapacityError(RuntimeError):
    """A block found more critical edges/triangles than its fixed-shape
    triplet buffers can hold.  Raised by :func:`run_front` (never a
    silent truncation); carries the observed peak and the capacity so
    callers can rerun with an explicit ``crit_cap``."""

    def __init__(self, observed: int, cap: int, dims, n_blocks: int):
        self.observed = int(observed)
        self.cap = int(cap)
        super().__init__(
            f"critical-simplex count {self.observed} exceeds the triplet "
            f"buffer capacity {self.cap} on at least one device (dims="
            f"{tuple(dims)}, n_blocks={n_blocks}); pass crit_cap="
            f"{self.observed} (or higher) to run_front/FrontConfig")


@dataclass(frozen=True)
class FrontConfig:
    dims: Tuple[int, int, int]        # global (nx, ny, nz)
    n_blocks: int
    # triplet buffer capacity per block; None auto-sizes from the grid
    # (overflow always raises CritCapacityError, never truncates)
    crit_cap: Optional[int] = None
    # resolution ring rotations; None derives a convergence bound from
    # n_blocks + plane size and stops early once nothing moves
    ring_rotations: Optional[int] = None
    gradient_backend: str = "fused"   # "fused" | "prepass" | "torch"
    gradient_chunk: Optional[int] = None  # vertices per plain-version call
    use_sample_sort: bool = True
    sort_slack: float = 2.0
    # interior planes from the un-extended slab, the two boundary planes
    # from 3-plane sub-volumes around the received halo (bit-identical);
    # the fused kernel always takes the whole halo volume
    overlap_comm: bool = True

    def __post_init__(self):
        if self.gradient_backend not in GRADIENT_BACKENDS:
            raise ValueError(f"unknown gradient_backend "
                             f"{self.gradient_backend!r}; expected one of "
                             f"{GRADIENT_BACKENDS}")

    @property
    def nz_local(self) -> int:
        nx, ny, nz = self.dims
        if self.n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {self.n_blocks}")
        if nz % self.n_blocks != 0:
            raise ValueError(
                f"nz={nz} does not divide evenly over n_blocks="
                f"{self.n_blocks} (dims={self.dims}); choose a block count "
                f"dividing the z extent")
        return nz // self.n_blocks

    @property
    def plane(self) -> int:
        return self.dims[0] * self.dims[1]

    @property
    def nv_local(self) -> int:
        return self.nz_local * self.plane

    @property
    def crit_capacity(self) -> int:
        """The explicit ``crit_cap``, else sized from the slab (a lower
        star emits at most a few critical cells per vertex)."""
        if self.crit_cap is not None:
            return self.crit_cap
        return min(7 * self.nv_local, max(4096, self.nv_local))

    def ring_rotation_count(self, ent_per_vertex: int = 1) -> int:
        """Rotations guaranteeing ring-resolution convergence: V-paths
        are strictly descending, so a chain crosses at most the
        ``2 * (n_blocks - 1) * plane * ent`` boundary entries, and
        resolved prefixes double per rotation."""
        if self.ring_rotations is not None:
            return self.ring_rotations
        boundary = 2 * max(1, self.n_blocks - 1) * self.plane \
            * max(1, ent_per_vertex)
        return max(3, int(np.ceil(np.log2(boundary))) + 1)


class _Steps:
    """Per-step seconds of one front-end run, each ending in a device
    synchronize (only when a ``stats`` dict asks for them)."""

    def __init__(self, stats: Optional[dict], device):
        self.stats = stats
        self.cuda = torch.device(device).type == "cuda"
        if stats is not None:
            stats.setdefault("steps", {})
        self.t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.stats is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        steps = self.stats["steps"]
        steps[name] = steps.get(name, 0.0) + t - self.t0
        self.t0 = t


def _gather_step(stats: dict, device, t0: float, stepped: float,
                 scope) -> None:
    """Close a ``run_front`` call's steps: ``gather``, what its steps left
    of the time since ``t0`` (``stepped``: their sum before the call),
    to a synchronize; then each resolved sub-span of ``scope`` added to
    the step named by its first part (``comm.shift`` -> ``comm``)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    steps = stats["steps"]
    own = sum(steps.values()) - stepped
    steps["gather"] = steps.get("gather", 0.0) + \
        time.perf_counter() - t0 - own
    if scope is not None:
        for k, sec in scope.resolve().items():
            top = k.split(".")[0]
            steps[top] = steps.get(top, 0.0) + sec


# --------------------------------------------------------------------------
# generic ring resolution of successor tables
# --------------------------------------------------------------------------

def _double_table(table, lo, n_local: int, iters: int):
    """Pointer doubling T <- T o T wherever entries point into the block's
    own range [lo, lo + n_local); ``table`` (Bl, n), ``lo`` (Bl,)."""
    lo = lo[:, None]
    for _ in range(iters):
        is_loc = (table >= lo) & (table < lo + n_local)
        idx = (table - lo).clamp(0, n_local - 1)
        table = torch.where(is_loc, torch.gather(table, 1, idx), table)
    return table


def _lookup(vals, table, lo, n_local: int):
    """One substitution of ``vals`` through a locally resolved table."""
    lo = lo[:, None]
    is_loc = (vals >= lo) & (vals < lo + n_local)
    idx = (vals - lo).clamp(0, n_local - 1)
    return torch.where(is_loc, torch.gather(table, 1, idx), vals)


def ring_resolve(cfg: FrontConfig, ring: Ring, table, ent_per_vertex: int,
                 queries, stats: Optional[dict] = None, name: str = ""):
    """Fully resolve a sharded successor table and extra query pointers.

    table: (Bl, n_local) global-space successors of the entities based in
    each block's slab (terminals point to themselves; OMEGA < 0 passes);
    queries: (Bl, q) pointers to resolve through the global table.
    Returns (table, queries, unresolved (Bl,)).  ``stats`` receives the
    rotations taken under ``ring_rotations.<name>``."""
    nb = cfg.n_blocks
    me = ring.blocks()
    P = cfg.plane * ent_per_vertex
    n_local = cfg.nv_local * ent_per_vertex
    lo = me * n_local
    log_iters = int(np.ceil(np.log2(max(2, n_local)))) + 1

    table = _double_table(table, lo, n_local, log_iters)
    queries = _lookup(queries, table, lo, n_local)
    unresolved = torch.zeros_like(me)
    rotations = 0
    if nb > 1:
        def substitute(vals, tabs, owner):
            off = vals - (owner * n_local)[:, None]
            in_first = (off >= 0) & (off < P)
            in_last = (off >= n_local - P) & (off < n_local)
            idx_f = off.clamp(0, P - 1)
            idx_l = (off - (n_local - P)).clamp(0, P - 1)
            out = torch.where(in_first, torch.gather(tabs[:, 0], 1, idx_f),
                              vals)
            return torch.where(in_last, torch.gather(tabs[:, 1], 1, idx_l),
                               out)

        def one_rotation(table, queries):
            old_t, old_q = table, queries
            tabs = torch.stack([table[:, :P], table[:, n_local - P:]], 1)
            owner = me
            for _ in range(nb):
                table = substitute(table, tabs, owner)
                queries = substitute(queries, tabs, owner)
                tabs = ring.shift(tabs, up=True, wrap=True)
                owner = (owner - 1) % nb
            # chains may have re-entered the slab: settle locally again
            table = _double_table(table, lo, n_local, log_iters)
            queries = _lookup(queries, table, lo, n_local)
            changed = (table != old_t).sum(1) + (queries != old_q).sum(1)
            return table, queries, changed

        max_rot = cfg.ring_rotation_count(ent_per_vertex)
        if cfg.ring_rotations is not None:
            # a fixed count; unresolved chains still show through the
            # stationarity count of the last rotation
            changed = torch.zeros_like(me)
            for _ in range(max_rot):
                table, queries, changed = one_rotation(table, queries)
            rotations = max_rot
            unresolved = ring.psum(changed)
        else:
            # the derived bound, stopping once no entry moved anywhere on
            # the ring (the psum makes the stop the same on every block)
            unresolved = torch.ones_like(me)
            while int(unresolved[0]) > 0 and rotations < max_rot:
                table, queries, changed = one_rotation(table, queries)
                unresolved = ring.psum(changed)
                rotations += 1
    if stats is not None:
        stats.setdefault("ring_rotations", {})[name] = rotations
    return table, queries, unresolved


# --------------------------------------------------------------------------
# the per-block program
# --------------------------------------------------------------------------

def _rank_bound(cfg: FrontConfig) -> Optional[int]:
    """Exclusive bound on rank values (None for rank-free keys): dense
    sample-sort ranks live in [0, nv_global) and go to the kernels as
    int32 below 2^31; rank-free keys stay full-width int64."""
    if not cfg.use_sample_sort:
        return None
    nx, ny, nz = cfg.dims
    return nx * ny * nz


def _gradient_rows(cfg: FrontConfig, ext=None, nbrs=None, ov=None):
    """Packed rows of one block: from its halo volume ``ext`` (fused
    kernel) or its (n, 27) neighbour orders ``nbrs`` and orders ``ov``."""
    rb = _rank_bound(cfg)
    if cfg.gradient_backend == "fused" and ext is not None:
        return fused_rows_from_halo_volume(ext, rank_bound=rb)
    if nbrs is None:
        nbrs, ov = halo_owned_neighbors(ext)
    if rb is not None and rb < 2 ** 31:
        nbrs, ov = nbrs.to(torch.int32), ov.to(torch.int32)
    if cfg.gradient_backend == "prepass":
        return lower_star_gradient_prepass(nbrs, ov, rank_bound=rb)
    c = cfg.gradient_chunk or max(1, nbrs.shape[0])
    parts = [lower_star_gradient_torch(nbrs[i:i + c], ov[i:i + c], rb)
             for i in range(0, nbrs.shape[0], c)]
    return tuple(torch.cat(p) for p in zip(*parts))


def halo_gradient(cfg: FrontConfig, ring: Ring, ranks: torch.Tensor,
                  steps: Optional[_Steps] = None):
    """Exchange the boundary rank planes with the ring neighbours and run
    the lower-star gradient on every held block's own vertices.

    ranks: (Bl, nv_local) global vertex ranks (or keys) of each slab.
    Returns (ext, (status, partner, vstat, vpart)): the (Bl, nz_local+2,
    ny, nx) halo volumes (-1 ghosts at the grid's ends) and the packed
    rows, (Bl, nv_local, ...).  The kernel takes one volume, so it is
    launched once per block.

    With ``cfg.overlap_comm`` (not for the fused kernel, nor for slabs
    under 3 planes) the shifts are started first, the interior planes
    ``[1, nz_local - 1)`` are processed from the un-extended slab while
    they are in flight, and only the two boundary planes wait for the
    halo (3-plane sub-volumes); the rows are per-vertex maps, so the
    stitched result is bit-identical to the monolithic path."""
    nx, ny, _ = cfg.dims
    nzl, plane, nvl = cfg.nz_local, cfg.plane, cfg.nv_local
    me = ring.blocks()
    nb = cfg.n_blocks
    Bl = ranks.shape[0]
    r3 = ranks.reshape(Bl, nzl, ny, nx)
    wait_below = ring.shift_async(r3[:, -1], up=True)
    wait_above = ring.shift_async(r3[:, 0], up=False)

    def halo():
        below = torch.where((me > 0)[:, None, None], wait_below(), -1)
        above = torch.where((me < nb - 1)[:, None, None], wait_above(), -1)
        ext = torch.cat([below[:, None], r3, above[:, None]], 1)
        if steps is not None:
            steps.mark("halo")
        return ext

    if not cfg.overlap_comm or nzl < 3 or cfg.gradient_backend == "fused":
        ext = halo()
        rows = [_gradient_rows(cfg, ext=ext[b]) for b in range(Bl)]
    else:
        eg_int = Grid.of(nx, ny, nzl)
        rows_int = []
        for b in range(Bl):
            nb_int = neighbor_orders(eg_int, ranks[b]) \
                .reshape(nzl, plane, 27)[1:-1].reshape(-1, 27)
            rows_int.append(_gradient_rows(
                cfg, nbrs=nb_int, ov=ranks[b, plane: nvl - plane]))
        ext = halo()
        eg_b = Grid.of(nx, ny, 3)

        def boundary(vol3, own):
            nb_ = neighbor_orders(eg_b, vol3.reshape(-1)) \
                .reshape(3, plane, 27)[1]
            return _gradient_rows(cfg, nbrs=nb_, ov=own)

        rows = []
        for b in range(Bl):
            lo = boundary(ext[b, :3], ranks[b, :plane])
            hi = boundary(ext[b, -3:], ranks[b, nvl - plane:])
            rows.append(tuple(torch.cat(p) for p in
                              zip(lo, rows_int[b], hi)))
    rows = tuple(torch.stack(p) for p in zip(*rows))
    if steps is not None:
        steps.mark("gradient")
    return ext, rows


def _nbr_at(ext: torch.Tensor, vloc: torch.Tensor,
            o: torch.Tensor) -> torch.Tensor:
    """The order of neighbour ``o`` (0..26, x fastest) of the held
    blocks' local vertices ``vloc`` (Bl, q), read from the halo volumes:
    what ``neighbor_orders`` over the volume would hold, -1 outside."""
    Bl, nzh, ny, nx = ext.shape
    x = vloc % nx + (o % 3 - 1)
    y = (vloc // nx) % ny + ((o // 3) % 3 - 1)
    z = vloc // (nx * ny) + 1 + (o // 9 - 1)
    inside = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
    flat = (z * ny + y.clamp(0, ny - 1)) * nx + x.clamp(0, nx - 1)
    val = torch.gather(ext.reshape(Bl, -1), 1, flat)
    return torch.where(inside, val, -1)


def _nonzero_padded(mask: torch.Tensor, cap: int):
    """Per block, the first ``cap`` indices of ``mask`` (Bl, L), padded
    with L - 1 (``jnp.nonzero(size=cap, fill_value=L - 1)``), and the
    count of set entries."""
    Bl, L = mask.shape
    b, i = torch.nonzero(mask, as_tuple=True)
    cnt = mask.sum(1)
    first = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(len(b), device=mask.device) - first[b]
    keep = pos < cap
    out = torch.full((Bl, cap), L - 1, dtype=torch.int64, device=mask.device)
    out[b[keep], pos[keep]] = i[keep]
    return out, cnt


def _tables(device) -> Dict[str, torch.Tensor]:
    return dict(shift=torch.as_tensor(GR.PACKED["row_shift"].astype(np.int64),
                                      device=device),
                rtype=torch.as_tensor(GR.PACKED["row_type"].astype(np.int64),
                                      device=device),
                oth=torch.as_tensor(GR.PACKED["others"].astype(np.int64),
                                    device=device),
                cof2=G.table("COFACES", 2, device),
                span3=G.table("SPAN", 3, device))


def _cofacet_sids(cfg: FrontConfig, T, bx, by, bz, tri_t):
    """(..., 2) global sids of the cofacet tets of the triangles with base
    (bx, by, bz) and type ``tri_t``, and their global validity."""
    nx, ny, nz = cfg.dims
    cof = T["cof2"][tri_t]                              # (..., 2, 4)
    cbx = bx[..., None] + cof[..., 1]
    cby = by[..., None] + cof[..., 2]
    cbz = bz[..., None] + cof[..., 3]
    span = T["span3"][cof[..., 0].clamp(min=0)]
    ok = (cof[..., 0] >= 0) \
        & (cbx >= 0) & (cbx + span[..., 0] <= nx - 1) \
        & (cby >= 0) & (cby + span[..., 1] <= ny - 1) \
        & (cbz >= 0) & (cbz + span[..., 2] <= nz - 1)
    csid = (cbx + nx * (cby + ny * cbz)) * G.NTYPES[3] + cof[..., 0]
    return csid, ok


def front_device_fn(cfg: FrontConfig, ring: Ring, f_slab: torch.Tensor,
                    stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The per-block program.  f_slab: (Bl, nv_local) float32, the held
    blocks' z-slabs.  Every output has the leading block axis; those the
    reference replicates (``overflow``, ``ncrit``, ``unresolved``,
    ``crit_peak``) are the same on every block."""
    nx, ny, nz = cfg.dims
    nzl, plane, nvl = cfg.nz_local, cfg.plane, cfg.nv_local
    nb = cfg.n_blocks
    dev = f_slab.device
    steps = _Steps(stats, dev)
    me = ring.blocks()
    Bl = f_slab.shape[0]
    has_above = me < nb - 1
    gid0 = me * nvl
    gids = gid0[:, None] + torch.arange(nvl, device=dev)

    # ---- 1. global order ------------------------------------------------
    fl = f_slab.reshape(Bl, nvl)
    if cfg.use_sample_sort and nb > 1:
        ranks, overflow = sample_sort_ranks(fl, gids, ring, nb,
                                            slack=cfg.sort_slack, stats=stats)
    elif cfg.use_sample_sort:
        key = rankfree_keys(fl, gids)
        ranks = torch.argsort(torch.argsort(key, dim=1), dim=1)
        overflow = torch.zeros(Bl, dtype=torch.bool, device=dev)
    else:
        ranks = rankfree_keys(fl, gids)
        overflow = torch.zeros(Bl, dtype=torch.bool, device=dev)
    steps.mark("order")

    # ---- 2+3. halo exchange of ranks, gradient on own vertices ----------
    ext, (status, partner, vstat, vpart) = halo_gradient(cfg, ring, ranks,
                                                         steps)

    T = _tables(dev)
    SHIFT, RTYPE, OTH = T["shift"], T["rtype"], T["oth"]
    vx = gids % nx
    vy = (gids // nx) % ny
    vz = gids // plane

    def to_gid(x, y, z):
        return x + nx * (y + ny * z)

    # ---- 4a. vertex successors (descending v-paths) ---------------------
    o = OTH[vpart.clamp(min=0).long(), 0]
    succ_v = torch.where(vstat == GR.TAIL,
                         to_gid(vx + o % 3 - 1, vy + (o // 3) % 3 - 1,
                                vz + o // 9 - 1), gids)

    # ---- 4b. tet successors (ascending dual paths), one tet row at a
    # time into a table covering bases [gid0 - plane, gid0 + nvl); the
    # ghost segment is then shipped down to its owner
    T3, T2 = G.NTYPES[3], G.NTYPES[2]
    off3 = GR.ROW_OFF[3]
    tab_lo = (gid0 - plane) * T3
    tab_n = (nvl + plane) * T3
    ttab = torch.full((Bl, tab_n + 1), -3, dtype=torch.int64, device=dev)
    for r in range(G.NSTAR[3]):
        row = off3 + r
        st = status[:, :, row]
        sh = GR.PACKED["row_shift"][row].astype(np.int64)
        tet = to_gid(vx - int(sh[0]), vy - int(sh[1]), vz - int(sh[2])) \
            * T3 + int(GR.PACKED["row_type"][row])
        prow = partner[:, :, row].clamp(min=0).long()
        psh = SHIFT[prow]
        tri = to_gid(vx - psh[..., 0], vy - psh[..., 1], vz - psh[..., 2]) \
            * T2 + RTYPE[prow]
        tb = tri // T2
        csid, ok = _cofacet_sids(cfg, T, tb % nx, (tb // nx) % ny,
                                 tb // plane, tri % T2)
        nxt = torch.where(ok & (csid != tet[..., None]), csid, -1).amax(-1)
        nxt = torch.where(nxt < 0, OMEGA, nxt)
        succ = torch.where(st == GR.CRIT, tet,
                           torch.where(st == GR.HEAD, nxt, -3))
        idx = torch.where(succ != -3, tet - tab_lo[:, None], tab_n) \
            .clamp(0, tab_n)
        ttab.scatter_(1, idx, succ)
        del st, tet, prow, psh, tri, tb, csid, ok, nxt, succ, idx
    ttab = ttab[:, :tab_n]
    recv = ring.shift(ttab[:, : plane * T3].contiguous(), up=False)
    seg = ttab[:, nvl * T3:]
    ttab[:, nvl * T3:] = torch.where((recv != -3) & has_above[:, None], recv,
                                     seg)
    tet_table = ttab[:, plane * T3:]
    # unset entries (-3) are tets never processed (invalid or ghost-only):
    # point them at OMEGA so chases cannot wander
    tet_table = torch.where(tet_table == -3, OMEGA, tet_table)
    del ttab, recv, seg
    steps.mark("successors")

    # ---- 5a. critical edges -> D0 triplets ------------------------------
    cap = cfg.crit_capacity
    crit1 = status[:, :, :G.NSTAR[1]] == GR.CRIT
    eidx, n_ce = _nonzero_padded(crit1.reshape(Bl, -1), cap)
    ce_v = torch.gather(gids, 1, eidx // G.NSTAR[1])
    ce_row = eidx % G.NSTAR[1]
    ou = OTH[ce_row, 0]
    ce_u = to_gid(ce_v % nx + ou % 3 - 1,
                  (ce_v // nx) % ny + (ou // 3) % 3 - 1,
                  ce_v // plane + ou // 9 - 1)
    vloc = (ce_v - gid0[:, None]).clamp(0, nvl - 1)
    key_hi = torch.gather(ranks, 1, vloc)
    lo_nbr = _nbr_at(ext, vloc, ou)
    ekey = torch.stack([key_hi, lo_nbr.to(torch.int64)], -1)
    valid_e = torch.arange(cap, device=dev)[None] < n_ce[:, None]

    # ---- 5b. critical triangles -> dual triplets ------------------------
    r2 = GR.ROW_OFF[2]
    crit2 = status[:, :, r2: r2 + G.NSTAR[2]] == GR.CRIT
    tidx, n_ct = _nonzero_padded(crit2.reshape(Bl, -1), cap)
    ct_v = torch.gather(gids, 1, tidx // G.NSTAR[2])
    ct_row = r2 + tidx % G.NSTAR[2]
    vloc = (ct_v - gid0[:, None]).clamp(0, nvl - 1)
    o1 = _nbr_at(ext, vloc, OTH[ct_row, 0]).to(torch.int64)
    o2 = _nbr_at(ext, vloc, OTH[ct_row, 1]).to(torch.int64)
    tkey = torch.stack([torch.gather(ranks, 1, vloc), torch.maximum(o1, o2),
                        torch.minimum(o1, o2)], -1)
    sh = SHIFT[ct_row]
    csid, ok = _cofacet_sids(cfg, T, ct_v % nx - sh[..., 0],
                             (ct_v // nx) % ny - sh[..., 1],
                             ct_v // plane - sh[..., 2], RTYPE[ct_row])
    csid = torch.where(ok, csid, -1)
    # compact to exactly two slots (a triangle has <= 2 cofacets); argmax
    # takes the first maximum, as jnp.argmax does
    first = torch.argmax(ok.to(torch.uint8), -1, keepdim=True)
    okc = ok.scatter(-1, first, False)
    second = torch.argmax(okc.to(torch.uint8), -1, keepdim=True)
    cof0 = torch.where(ok.any(-1), torch.gather(csid, -1, first)[..., 0],
                       OMEGA)
    cof1 = torch.where(okc.any(-1), torch.gather(csid, -1, second)[..., 0],
                       OMEGA)
    valid_t = torch.arange(cap, device=dev)[None] < n_ct[:, None]
    steps.mark("emission")

    # ---- 6. resolve all traces ------------------------------------------
    # padding rows must not wander: mask them to OMEGA before resolving
    vq = torch.where(torch.cat([valid_e, valid_e], 1),
                     torch.cat([ce_v, ce_u], 1), OMEGA)
    _, vq_res, un_v = ring_resolve(cfg, ring, succ_v, 1, vq, stats, "v")
    tq = torch.where(torch.cat([valid_t, valid_t], 1),
                     torch.cat([cof0, cof1], 1), OMEGA)
    del succ_v
    _, tq_res, un_t = ring_resolve(cfg, ring, tet_table, T3, tq, stats, "t")
    steps.mark("resolution")

    st3 = status[:, :, off3:]
    ncrit = torch.stack([ring.psum((vstat == GR.CRIT).sum(1)),
                         ring.psum(n_ce), ring.psum(n_ct),
                         ring.psum((st3 == GR.CRIT).sum((1, 2)))], 1)
    # buffer overflow detection: the largest per-block critical count,
    # checked against the capacity by run_front (raise, never truncate)
    crit_peak = ring.pmax(torch.maximum(n_ce, n_ct))
    if stats is not None:
        # the tet table, and per triplet slot 13 int64 words (D0: key 2,
        # t0, t1, sid_v, row; dual: key 3, t0, t1, sid_v, row) + 2 flags
        stats["buffers"] = dict(
            tet_table_bytes=Bl * tab_n * 8,
            triplet_bytes=Bl * cap * (13 * 8 + 2),
            sort_buffer_bytes=stats.get("sort_buffer_bytes", 0))
    return dict(
        ranks=ranks, overflow=overflow,
        d0_key=ekey, d0_t0=vq_res[:, :cap], d0_t1=vq_res[:, cap:],
        d0_valid=valid_e, d0_sid_v=ce_v, d0_row=ce_row,
        dual_key=tkey, dual_t0=tq_res[:, :cap], dual_t1=tq_res[:, cap:],
        dual_valid=valid_t, dual_sid_v=ct_v, dual_row=ct_row,
        ncrit=ncrit, unresolved=un_v + un_t, crit_peak=crit_peak,
        vstat=vstat, vpart=vpart, status=status, partner=partner)


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

REPLICATED = ("overflow", "ncrit", "unresolved", "crit_peak")


def run_front(dims, f, n_blocks: int, ring: Optional[Ring] = None,
              device=None, stats: Optional[dict] = None, **cfg_kw):
    """Run the distributed front-end on ``n_blocks`` z-slabs of the field
    ``f`` (flat or shaped, numpy or torch, the whole grid).

    ``ring`` defaults to :func:`~.comm.block_ring`: a :class:`GroupRing`
    over the default process group where one is initialised (every rank
    of it must make the call and runs its own ``n_blocks / world``
    blocks; ``device``, or else the device a tensor ``f`` off the host
    lies on, must be the group's), else a :class:`LocalRing` on
    ``device`` (``None`` means ``"cuda"``).  Such a field moves to
    another device only where ``device`` asks for it: otherwise a ring
    elsewhere raises ``ValueError``.  Returns ``(cfg, out)``, the same
    on every rank: ``out`` holds the reference's keys as tensors, blocked
    outputs concatenated over the blocks in order, the replicated ones
    once.
    ``stats`` (a dict) receives the per-step seconds, ring rotations,
    sample-sort bucket peak and buffer sizes.  Its ``steps`` add
    ``gather`` (from the ``resolution`` step's end to the return: the
    replicated reductions, the gather of every block's outputs and the
    ``crit_peak`` read) and, over a ``GroupRing``, ``comm``: the device
    seconds of the ring's ``comm.<op>`` sub-spans, the time the compute
    stream waited on the group.
    Raises :class:`CritCapacityError` (after a flight-recorder dump) when
    a block overflows its triplet buffers."""
    cfg = FrontConfig(tuple(int(d) for d in dims), n_blocks, **cfg_kw)
    cfg.nz_local  # eager divisibility check: fail with dims/blocks named
    f = f if isinstance(f, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(f))
    # a field off the host stays on its device unless ``device`` asks
    home = f.device if device is None and f.device.type != "cpu" else None
    if ring is None:
        ring = block_ring(n_blocks, device if home is None else home)
    elif ring.n_blocks != n_blocks:
        raise ValueError(f"the ring has {ring.n_blocks} blocks, not "
                         f"{n_blocks}")
    if home is not None and ring.device != home:
        raise ValueError(f"the field lies on {home} and the ring on "
                         f"{ring.device}; pass device= to move it")
    f_slab = f.reshape(n_blocks, cfg.nv_local).to(
        device=ring.device, dtype=torch.float32)[ring.blocks()]
    # with stats, the call is a scope of the ring's comm sub-spans, under
    # a trace of its own where none is active
    own = Trace() if stats is not None and current_trace() is None \
        else None
    with trace_active(own), sub_scope(
            current_trace() if stats is not None else None, "") as scope:
        t0 = time.perf_counter()
        stepped = sum(stats.get("steps", {}).values()) if stats else 0.0
        out = front_device_fn(cfg, ring, f_slab, stats)
        out = {k: (v[0] if k in REPLICATED
                   else ring.gather_blocks(v).flatten(0, 1))
               for k, v in out.items()}
        peak = int(out["crit_peak"])
        if stats is not None:
            _gather_step(stats, ring.device, t0, stepped, scope)
    if peak > cfg.crit_capacity:
        err = CritCapacityError(peak, cfg.crit_capacity, cfg.dims, n_blocks)
        _flight.crash_dump("crit_capacity", exc=err)
        raise err
    return cfg, out


def _vrow_to_sid(dims, v: torch.Tensor, row: torch.Tensor, k: int):
    """(vertex, packed row) -> global simplex sid."""
    nx, ny, _ = dims
    sh = torch.as_tensor(GR.PACKED["row_shift"].astype(np.int64),
                         device=v.device)[row]
    t = torch.as_tensor(GR.PACKED["row_type"].astype(np.int64),
                        device=v.device)[row]
    bx = v % nx - sh[:, 0]
    by = (v // nx) % ny - sh[:, 1]
    bz = v // (nx * ny) - sh[:, 2]
    return (bx + nx * (by + ny * bz)) * G.NTYPES[k] + t


def front_triplets(dims, out):
    """(saddle sid, key, t0, t1) triplet tensors of the D0 and dual
    graphs from :func:`run_front`'s outputs (valid rows only)."""
    d0v = out["d0_valid"].bool()
    sid0 = _vrow_to_sid(dims, out["d0_sid_v"][d0v], out["d0_row"][d0v], 1)
    dv = out["dual_valid"].bool()
    # dual_row stores packed rows (14..49)
    sidd = _vrow_to_sid(dims, out["dual_sid_v"][dv], out["dual_row"][dv], 2)
    return ((sid0, out["d0_key"][d0v], out["d0_t0"][d0v], out["d0_t1"][d0v]),
            (sidd, out["dual_key"][dv], out["dual_t0"][dv],
             out["dual_t1"][dv]))
