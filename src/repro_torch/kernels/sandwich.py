"""Batched sandwich back-end: the D0 / D_{d-1} / D1 pairing phases.

PyTorch counterpart of ``repro.kernels.sandwich``; every phase runs as
tensor programs on the device of the gradient, and gives the same pairs
and essential classes as the reference, bit for bit:

- :func:`extract_critical_kernel` — critical extraction with
  order-isomorphic ranks: vertex ranks are the vertex order, edge ranks
  the packed ``o_max * 2^31 + o_min`` key (computed for the critical
  edges to sort them; the dense array over every edge sid is built only
  when a later stage reads ``ranks[1]``), and triangle / tet ranks are
  computed among critical simplices only (the only places they are
  compared);
- :func:`pair_extrema_saddles_kernel` — the elder-rule Union-Find as a
  pointer-jumping fixpoint: each round chases representatives, picks the
  oldest proposing saddle per extremum with ``scatter_reduce_("amin")``
  and rebuilds the links with masked index writes;
- :func:`build_dual_graph_chase` — the dual extremum graph with the
  stable-set terminals resolved from the saddle cofacets only;
- :func:`pair_saddle_saddle_wavefront` — D1 homologous propagation as a
  wavefront over all active columns at once (rank-bucketed batches,
  optimistic claims with steals); below ``burst_below`` columns a
  sequential lazy-heap reducer on the host.

The positive-highest-edge invariant raises :class:`GradientInvariantError`.
"""

from __future__ import annotations

import heapq
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.critical import CriticalInfo, DeferredRanks
from repro_torch.core.extremum_graph import ExtremumGraph
from repro_torch.core.gradient import GradientField
from repro_torch.core.grid import FACES, NTYPES, Grid, table
from repro_torch.core.pairing import ExtremaPairs
from repro_torch.core.saddle_saddle import SaddleSaddlePairs
from repro_torch.core.tracing import (OMEGA, _exit_cofacet, resolve_chase,
                                      resolve_doubling, tet_successors)
from repro_torch.obs.metrics import global_metrics
from repro_torch.obs.trace import current_trace, maybe_span, sub_span

NOKEY = int(np.iinfo(np.int64).max)    # "unassigned" representative tag
CUDA_BATCH = 1 << 20                   # D1 wavefront columns per batch


class GradientInvariantError(ValueError):
    """A 1-cycle's highest edge must be *positive* (it created the
    cycle): propagation reaching a negative edge — one that died in D0
    or was paired with a vertex — means the gradient field is
    inconsistent with the filtration."""


def _invariant_error(e: int) -> GradientInvariantError:
    return GradientInvariantError(
        f"D1 propagation reached edge sid {e}, which is neither "
        f"gradient-paired upward nor an unpaired critical edge: a 1-cycle's "
        f"highest edge must be positive — the gradient field is "
        f"inconsistent")


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _lexsort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting the rows of (n, c) ``keys`` lexicographically
    (column 0 most significant): chained stable argsorts, last key first."""
    perm = _arange(keys.shape[0], keys)
    for c in range(keys.shape[1] - 1, -1, -1):
        perm = perm[torch.argsort(keys[perm, c], stable=True)]
    return perm


# --------------------------------------------------------------------------
# Critical extraction without the dense lexsort
# --------------------------------------------------------------------------

def _rank_compress(order: torch.Tensor) -> torch.Tensor:
    """Dense [0, nv) ranks of an injective int64 key field."""
    perm = torch.argsort(order, stable=True)
    out = torch.empty_like(perm)
    out[perm] = _arange(len(order), order)
    return out


def edge_keys_kernel(grid: Grid, o: torch.Tensor,
                     sids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed edge key ``o_max * 2^31 + o_min`` of each edge sid in
    ``sids``, or of every edge sid when ``sids`` is None (requires
    ``o < 2^31``); -1 on invalid sids.  An edge's vertices are its base
    vertex and the base shifted by its type's ``SPAN``: validity and the
    far vertex share one coordinate decomposition, and no mask compaction
    syncs with the host (the 7.8 M critical edges of a 336^3 field in
    1.81 ms against 7.61 ms with ``simplex_valid`` + ``simplex_vertices``,
    H100 80GB HBM3)."""
    sids = _arange(grid.sid_space(1), o) if sids is None else sids.long()
    base, t = grid.simplex_base_type(1, sids)
    x, y, z = grid.vid_to_xyz(base)
    sx, sy, sz = table("SPAN", 1, sids.device).T
    x += sx[t]
    y += sy[t]
    z += sz[t]
    nx, ny, nz = grid.dims
    valid = (x < nx) & (y < ny) & (z < nz) & (sids >= 0)
    base = base.clamp(min=0)
    far = torch.where(valid, grid.xyz_to_vid(x, y, z), base)
    a, b = o[base].long(), o[far].long()
    return torch.where(valid, (torch.maximum(a, b) << 31)
                       + torch.minimum(a, b), -1)


def _dense_edge_keys(grid: Grid, o: torch.Tensor):
    """The deferred dense :func:`edge_keys_kernel` for
    :class:`DeferredRanks`: it runs under the ``edge_keys`` sub-span of
    whichever stage reads ``ranks[1]`` first, and counts itself in
    ``pairing.dense_edge_keys`` (and the trace's ``dense_edge_keys``)."""
    def build() -> torch.Tensor:
        global_metrics().counter("pairing.dense_edge_keys").inc()
        tr = current_trace()
        if tr is not None:
            tr.count("dense_edge_keys", 1)
        with sub_span("edge_keys", o.device):
            return edge_keys_kernel(grid, o)
    return build


def extract_critical_kernel(grid: Grid, gf: GradientField,
                            order: torch.Tensor) -> CriticalInfo:
    """Critical extraction with order-isomorphic ranks.  Dimension 0's is
    the order; dimension 1 keys only its critical edges to sort them, and
    its dense key array is deferred (:class:`DeferredRanks`: built on the
    first read of ``ranks[1]``, from the same ``o``); dimensions >= 2 rank
    only their critical simplices.  Same ``crit_sids`` sequences as the
    reference dense lexsort."""
    order = order.reshape(-1)
    o = order if order.numel() == 0 or int(order.max()) < 2 ** 31 \
        else _rank_compress(order)
    dev = o.device
    crit_sids: Dict[int, torch.Tensor] = {}
    ranks: Dict[int, torch.Tensor] = {}
    for k in range(grid.dim + 1):
        with sub_span("select", dev):
            cs = gf.critical_sids(k)
        if k == 0:
            ranks[0] = o.long()
        elif k == 1:
            with sub_span("edge_keys", dev):
                ck = edge_keys_kernel(grid, o, cs)
        else:
            with sub_span("ranks", dev):
                perm = _lexsort_rows(grid.simplex_key(k, cs, o.long()))
                rk = torch.full((grid.sid_space(k),), -1,
                                dtype=torch.int64, device=dev)
                rk[cs[perm]] = _arange(len(cs), cs)
                ranks[k] = rk
        with sub_span("sort", dev):
            key = ck if k == 1 else ranks[k][cs]
            crit_sids[k] = cs[torch.argsort(key, stable=True)]
    if grid.dim >= 1:
        ranks = DeferredRanks(ranks, 1, _dense_edge_keys(grid, o))
    return CriticalInfo(grid, order, crit_sids, ranks)


# --------------------------------------------------------------------------
# D0 pairing: pointer-jumping fixpoint
# --------------------------------------------------------------------------

def _compact_nodes(t0: torch.Tensor, t1: torch.Tensor):
    """Map extremum ids (+ OMEGA) to compact [0, ne]; OMEGA -> ne."""
    nodes = torch.unique(torch.cat([t0, t1]), sorted=True)
    nodes = nodes[nodes != OMEGA]
    ne = len(nodes)

    def remap(a: torch.Tensor) -> torch.Tensor:
        om = a == OMEGA
        return torch.where(om, ne, torch.searchsorted(nodes, a))

    return nodes, remap(t0), remap(t1), ne


def _d0_round(c0, c1, skey, ekey, rep, repkey):
    """One self-correcting round: age-filtered find (follow rep links only
    while the assigning saddle is older), per-triplet proposals, and an
    oldest-saddle-wins rebuild by scatter-min.  Returns the new (rep,
    repkey, pair), the proposal mask and the host reads of the find (one
    a jump, and the last that finds none)."""
    m = len(rep)
    cur = torch.stack([c0, c1], dim=1)
    reads = 0
    while True:
        step = repkey[cur] < skey[:, None]
        reads += 1
        if not bool(step.any()):
            break
        cur = torch.where(step, rep[cur], cur)
    r0, r1 = cur[:, 0], cur[:, 1]
    prop = r0 != r1
    younger = ekey[r0] >= ekey[r1]
    die = torch.where(younger, r0, r1)
    live = torch.where(younger, r1, r0)
    win = torch.full((m,), NOKEY, dtype=torch.int64, device=rep.device)
    win.scatter_reduce_(0, die, torch.where(prop, skey, NOKEY), "amin")
    is_win = prop & (win[die] == skey)
    tgt = die[is_win]
    new_rep = _arange(m, rep)
    new_rep[tgt] = live[is_win]
    new_repkey = torch.full_like(repkey, NOKEY)
    new_repkey[tgt] = skey[is_win]
    new_pair = torch.full_like(rep, -1)
    new_pair[tgt] = _arange(len(skey), skey)[is_win]
    return new_rep, new_repkey, new_pair, prop, reads


def _fixpoint_init(g: ExtremumGraph):
    """Compact nodes, saddle and extremum keys and the empty state (rep,
    repkey, pair) of the D0 fixpoint on a non-empty graph."""
    dev = g.saddles.device
    nodes, c0, c1, ne = _compact_nodes(g.t0.long(), g.t1.long())
    m = ne + 1                                   # + the OMEGA slot
    skey = _arange(len(g.saddles), c0)
    ekey = torch.empty(m, dtype=torch.int64, device=dev)
    ekey[:ne] = g.ext_key.long()[nodes]
    ekey[ne] = -(2 ** 62)                        # OMEGA: oldest, never dies
    rep = _arange(m, c0)
    repkey = torch.full((m,), NOKEY, dtype=torch.int64, device=dev)
    pair = torch.full((m,), -1, dtype=torch.int64, device=dev)
    return nodes, c0, c1, ne, skey, ekey, rep, repkey, pair


def _no_pairs(g: ExtremumGraph) -> ExtremaPairs:
    z = torch.zeros(0, dtype=torch.int64, device=g.saddles.device)
    return ExtremaPairs(z, z, z)


def pair_extrema_saddles_kernel(g: ExtremumGraph) -> ExtremaPairs:
    """Elder-rule pairing as a pointer-jumping fixpoint (same result as the
    sequential ``pair_extrema_saddles``)."""
    if len(g.saddles) == 0:
        return _no_pairs(g)
    nodes, c0, c1, ne, skey, ekey, rep, repkey, pair = _fixpoint_init(g)
    tr = current_trace()
    n_rounds = syncs = 0

    def equal(a, b):
        nonlocal syncs
        syncs += 1
        return torch.equal(a, b)
    while True:
        n_rounds += 1
        with maybe_span(tr, "d0_round", round=n_rounds):
            new_rep, new_repkey, new_pair, _, reads = _d0_round(
                c0, c1, skey, ekey, rep, repkey)
        syncs += reads
        if equal(new_rep, rep) and equal(new_pair, pair) \
                and equal(new_repkey, repkey):
            break
        rep, repkey, pair = new_rep, new_repkey, new_pair
    global_metrics().counter("pairing.d0_rounds").inc(n_rounds)
    if tr is not None:
        tr.count("host_syncs", syncs)
    return _extrema_pairs(g, nodes, pair, ne)


def _extrema_pairs(g: ExtremumGraph, nodes: torch.Tensor, pair: torch.Tensor,
                   ne: int) -> ExtremaPairs:
    """The pairs of a converged fixpoint: extremum ``nodes[e]`` dies at
    saddle ``pair[e]`` (-1: unpaired), in extremum order."""
    e_idx = torch.nonzero(pair[:ne] >= 0).reshape(-1)
    mask = torch.ones(ne, dtype=torch.bool, device=pair.device)
    mask[e_idx] = False
    return ExtremaPairs(g.saddles.long()[pair[e_idx]], nodes[e_idx],
                        nodes[mask])


# --------------------------------------------------------------------------
# Dual extremum graph with chase-based terminal resolution
# --------------------------------------------------------------------------

def _chase_lazy(grid: Grid, gf: GradientField,
                starts: torch.Tensor) -> torch.Tensor:
    """Follow ascending dual v-paths computing successors on demand (no
    dense pass over the top-simplex space)."""
    pd = gf.pair_down[grid.dim].long()
    cur = starts.clone()
    while True:
        tau = torch.where(cur >= 0, pd[cur.clamp(min=0)], -1)
        mov = tau >= 0                  # unpaired (critical) tets stay
        if not bool(mov.any()):
            return cur
        cur = cur.clone()
        cur[mov] = _exit_cofacet(grid, cur[mov], tau[mov])


def build_dual_graph_chase(grid: Grid, gf: GradientField, ci: CriticalInfo,
                           saddles: torch.Tensor, *,
                           strategy: str = "auto") -> ExtremumGraph:
    """Dual extremum graph of the (d-1)-saddles ``saddles``, with stable-set
    terminals resolved from the saddle cofacets only.  ``strategy``:
    ``"lazy"``, ``"chase"``, ``"doubling"`` or ``"auto"`` (by frontier
    size)."""
    d = grid.dim
    saddles = saddles.long()
    sig = saddles[torch.argsort(-ci.ranks[d - 1][saddles], stable=True)]
    cof = grid.simplex_cofaces(d - 1, sig)
    t = torch.full((len(sig), 2), OMEGA, dtype=torch.int64, device=sig.device)
    cnt = torch.zeros(len(sig), dtype=torch.int64, device=sig.device)
    for i in range(cof.shape[1] if len(sig) else 0):
        cc = cof[:, i]
        ok = cc >= 0
        if bool((ok & (cnt >= 2)).any()):
            raise ValueError("non-manifold cofacet count")
        t[:, 0] = torch.where(ok & (cnt == 0), cc, t[:, 0])
        t[:, 1] = torch.where(ok & (cnt == 1), cc, t[:, 1])
        cnt += ok
    real = t >= 0
    starts = t[real]
    if len(starts):
        uniq, inv = torch.unique(starts, sorted=True, return_inverse=True)
        if strategy == "auto":
            if len(uniq) * 8 > grid.sid_space(d):
                strategy = "doubling"          # dense wins on huge fronts
            elif len(uniq) <= 4096:
                strategy = "lazy"
            else:
                strategy = "chase"
        if strategy == "doubling":
            t[real] = resolve_doubling(tet_successors(grid, gf))[starts]
        elif strategy == "lazy":
            t[real] = _chase_lazy(grid, gf, uniq)[inv]
        elif strategy == "chase":
            t[real] = resolve_chase(tet_successors(grid, gf), uniq)[inv]
        else:
            raise ValueError(f"unknown dual-chase strategy {strategy!r}")
    keep = t[:, 0] != t[:, 1]
    return ExtremumGraph(sig[keep], t[keep, 0], t[keep, 1], -ci.ranks[d])


# --------------------------------------------------------------------------
# D1: wavefront reduction over sparse columns
# --------------------------------------------------------------------------

def _pair_d1_burst(grid: Grid, pair_up1: np.ndarray, is_c1: np.ndarray,
                   erank: np.ndarray,
                   order_c2: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Sequential lazy-heap reduction for small column counts (host
    Python).  Columns run in filtration order, so a claim is never
    stolen and the result is exactly the sequential reduction's."""
    nx, ny, _ = grid.dims
    ntri = NTYPES[2]
    nedg = NTYPES[1]
    ftab = [[(int(e[0]), int(e[1]), int(e[2]), int(e[3])) for e in row]
            for row in FACES[2]]

    def faces3(sid: int) -> List[int]:
        base, t = divmod(sid, ntri)
        x = base % nx
        r = base // nx
        y = r % ny
        z = r // ny
        return [((x + dx) + nx * ((y + dy) + ny * (z + dz))) * nedg + ft
                for ft, dx, dy, dz in ftab[t]]

    n2 = len(order_c2)
    claim: Dict[int, int] = {}
    stored: Dict[int, list] = {}
    pair_edge = np.full(n2, -1, dtype=np.int64)
    expansions = 0
    rounds = 0
    for g in range(n2):
        h = [(-int(erank[e]), e) for e in faces3(int(order_c2[g]))]
        heapq.heapify(h)
        while True:
            piv = None
            while h:                     # pop max, cancelling mod-2 pairs
                k = heapq.heappop(h)
                if h and h[0] == k:
                    heapq.heappop(h)
                    continue
                piv = k
                break
            if piv is None:
                break                    # boundary vanished: essential
            rounds += 1
            e = piv[1]
            up = int(pair_up1[e])
            if up >= 0:
                expansions += 1
                for f in faces3(up):     # XOR dV(e); the popped e cancels
                    if f != e:
                        heapq.heappush(h, (-int(erank[f]), f))
                continue
            if not is_c1[e]:
                raise _invariant_error(e)
            holder = claim.get(e)
            if holder is None:
                claim[e] = g
                pair_edge[g] = e
                stored[g] = h            # pivot excluded: a merge cancels
                break                    # it by never re-adding it
            expansions += 1
            for entry in stored[holder]:
                heapq.heappush(h, entry)
    return pair_edge, expansions, rounds


def pair_saddle_saddle_wavefront(grid: Grid, gf: GradientField,
                                 ci: CriticalInfo, c1: torch.Tensor,
                                 c2: torch.Tensor, *,
                                 batch: Optional[int] = None,
                                 burst_below: int = 512
                                 ) -> SaddleSaddlePairs:
    """D1 homologous propagation, all columns advancing per round.

    ``c1``: unpaired critical edges; ``c2``: unpaired critical triangles.
    Same pairs / essential classes as the sequential reduction, and the
    same round and expansion counts as the reference's wavefront at the
    same ``batch``.  Fewer than ``burst_below`` columns go to the host
    lazy-heap reducer.

    The reference keeps the columns of a batch as a dense (C, W) block
    padded to the widest column; here each column is a segment of one
    flat edge pool (see :class:`_Wavefront`), so memory follows the live
    entries and one very long 1-cycle costs only its own length.
    Columns are admitted in rank-ordered batches of ``batch`` (default
    4096 on the CPU, as the reference; ``CUDA_BATCH`` on a GPU, where a
    round costs mostly launch and synchronize latency and fewer, wider
    batches mean fewer rounds); the batch size changes the round count,
    never the result."""
    dev = gf.pair_up[1].device
    if batch is None:
        batch = 4096 if dev.type == "cpu" else CUDA_BATCH
    erank = ci.ranks[1]
    trank = ci.ranks[2]
    c1 = c1.long()
    c2 = c2.long()
    n2 = len(c2)
    E = grid.sid_space(1)
    order_c2 = c2[torch.argsort(trank[c2], stable=True)]

    if n2 < burst_below:
        is_c1 = np.zeros(E, dtype=bool)
        is_c1[c1.cpu().numpy()] = True
        pair_edge, expansions, rounds = _pair_d1_burst(
            grid, gf.pair_up[1].cpu().numpy(), is_c1, erank.cpu().numpy(),
            order_c2.cpu().numpy())
        return _d1_result(order_c2, c1,
                          torch.as_tensor(pair_edge, device=dev),
                          expansions, rounds)

    is_c1 = torch.zeros(E, dtype=torch.bool, device=dev)
    is_c1[c1] = True
    pair_up1 = gf.pair_up[1].long()
    # expansion-face table: one dense gather instead of a per-round
    # simplex_faces call (only with enough columns, and not on huge grids)
    T = grid.sid_space(2)
    tri_faces = None
    if n2 >= 256 and T <= (1 << 23):
        tri_faces = grid.simplex_faces(2, _arange(T, c2))

    def faces_of(tris: torch.Tensor) -> torch.Tensor:
        if tri_faces is not None:
            return tri_faces[tris]
        return grid.simplex_faces(2, tris)

    st = _Wavefront(erank, pair_up1, is_c1, faces_of, n2)
    for lo in range(0, n2, batch):
        st.run_batch(order_c2, lo, min(batch, n2 - lo))
    return _d1_result(order_c2, c1, st.pair_edge, st.expansions, st.rounds)


def _segments(starts: torch.Tensor, lens: torch.Tensor):
    """Flat gather index of the segments ``[starts[i], starts[i] +
    lens[i])`` and the segment number of each position."""
    seg = torch.repeat_interleave(_arange(len(lens), lens), lens)
    first = torch.cumsum(lens, 0) - lens
    pos = _arange(int(lens.sum()), lens) - first[seg]
    return starts[seg] + pos, seg


def _by_col_key(col: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Permutation sorting entries by (column, key)."""
    p = torch.argsort(key, stable=True)
    return p[torch.argsort(col[p], stable=True)]


class _Wavefront:
    """State of the batched D1 wavefront across batches: the claim table
    (edge -> global column), the contest scratch, each column's paired
    edge, and the final columns of every finished batch (``frozen``: its
    first column, per-column start and length, and the edge pool)."""

    def __init__(self, erank, pair_up1, is_c1, faces_of, n2: int):
        dev = erank.device
        E = len(erank)
        self.erank, self.pair_up1, self.is_c1 = erank, pair_up1, is_c1
        self.faces_of = faces_of
        self.claim = torch.full((E,), -1, dtype=torch.int64, device=dev)
        self.win = torch.full((E,), NOKEY, dtype=torch.int64, device=dev)
        self.pair_edge = torch.full((n2,), -1, dtype=torch.int64, device=dev)
        self.frozen: List[tuple] = []
        self.expansions = 0
        self.rounds = 0

    def run_batch(self, order_c2: torch.Tensor, lo: int, C: int) -> None:
        """Reduce the columns [lo, lo + C) to completion.

        Column c is ``pool[start[c] : start[c] + nlen[c]]``, its edges in
        ascending key order, so its pivot is the last one.  A round writes
        the new entries of the columns it changed at the end of the pool
        and repoints them; the pool is compacted once it is mostly dead
        entries, so a round costs what its changed columns hold, not what
        the whole batch holds."""
        hi = lo + C
        dev = order_c2.device
        erank, claim, win, pair_edge = (self.erank, self.claim, self.win,
                                        self.pair_edge)
        tri = self.faces_of(order_c2[lo:hi])                  # (C, 3)
        pool = torch.gather(tri, 1, torch.argsort(erank[tri], dim=1,
                                                  stable=True)).reshape(-1)
        start = _arange(C, pool) * 3
        nlen = torch.full((C,), 3, dtype=torch.int64, device=dev)
        live = 3 * C
        active = torch.ones(C, dtype=torch.bool, device=dev)
        tr = current_trace()
        while True:
            idx = torch.nonzero(active).reshape(-1)
            if len(idx) == 0:
                break
            self.rounds += 1
            with (tr.span("d1_round", round=self.rounds) if tr is not None
                  else nullcontext()):
                # -- retirement: column vanished -> essential 2-class --------
                empty = nlen[idx] == 0
                if bool(empty.any()):
                    active[idx[empty]] = False
                    idx = idx[~empty]
                    if len(idx) == 0:
                        continue
                piv = pool[start[idx] + nlen[idx] - 1]    # highest edge
                # -- classify the live pivots -------------------------------
                up = self.pair_up1[piv]
                expand = up >= 0
                crit = ~expand
                ex_rows = idx[expand]
                mg_rows = idx[:0]
                mg_hold = idx[:0]
                if bool(crit.any()):
                    bad = ~self.is_c1[piv[crit]]
                    if bool(bad.any()):
                        raise _invariant_error(int(piv[crit][bad][0]))
                    # -- critical pivots: merge / contest -------------------
                    crit_rows = idx[crit]
                    cpiv = piv[crit]
                    holder = claim[cpiv]             # global index or -1
                    mine = crit_rows + lo
                    merge = (holder >= 0) & (holder < mine)
                    contest = ~merge                 # unclaimed, or stealable
                    if bool(contest.any()):
                        # contest winner per pivot: the lowest global index
                        cand_rows = crit_rows[contest]
                        cand_piv = cpiv[contest]
                        win[cand_piv] = NOKEY    # reset only touched slots
                        win.scatter_reduce_(0, cand_piv, cand_rows + lo,
                                            "amin")
                        is_win = win[cand_piv] == cand_rows + lo
                        wrows = cand_rows[is_win]
                        wpiv = cand_piv[is_win]
                        # steal: the displaced (younger) holder reopens; next
                        # round it sees the new claim and merges the winner
                        old = claim[wpiv]
                        reopen = old[(old >= lo) & (old < hi)]
                        if len(reopen):
                            active[reopen - lo] = True
                            pair_edge[reopen] = -1
                        claim[wpiv] = wrows + lo
                        pair_edge[wrows + lo] = wpiv
                        active[wrows] = False        # provisionally retired
                    mg_rows = crit_rows[merge]
                    mg_hold = claim[cpiv[merge]]     # read after the steals
                op_rows = torch.cat([ex_rows, mg_rows])
                if len(op_rows) == 0:
                    continue                         # contest losers wait
                self.expansions += len(op_rows)
                # -- XOR: an expansion adds the 3 faces of its paired
                # triangle, a merge the holder's whole boundary -------------
                gi, seg = _segments(start[op_rows], nlen[op_rows])
                cc = [op_rows[seg], ex_rows.repeat_interleave(3)]
                ce = [pool[gi], self.faces_of(up[expand]).reshape(-1)]
                if len(mg_hold):
                    for sel, s_start, s_len, src in self._holder_segments(
                            mg_hold, lo, start, nlen, pool):
                        hg, hseg = _segments(s_start, s_len)
                        cc.append(mg_rows[sel][hseg])
                        ce.append(src[hg])
                cc, ce = torch.cat(cc), torch.cat(ce)
                p = _by_col_key(cc, erank[ce])
                cc, ce = cc[p], ce[p]
                # mod-2: an edge twice in one column (at most twice: the
                # operands are sets) cancels
                eq = (cc[1:] == cc[:-1]) & (ce[1:] == ce[:-1])
                rm = torch.zeros(len(cc), dtype=torch.bool, device=dev)
                rm[1:] |= eq
                rm[:-1] |= eq
                cc, ce = cc[~rm], ce[~rm]
                counts = torch.bincount(cc, minlength=C)
                first = torch.cumsum(counts, 0) - counts
                start[op_rows] = len(pool) + first[op_rows]
                nlen[op_rows] = counts[op_rows]
                live += len(ce) - len(gi)
                pool = torch.cat([pool, ce])
                if len(pool) > 2 * live + 4096:
                    pool, start = self._compact(pool, start, nlen)
        pool, start = self._compact(pool, start, nlen)
        # batch done: freeze it (claim holders keep their boundary; every
        # other column has vanished)
        self.frozen.append((lo, start, nlen, pool))

    @staticmethod
    def _compact(pool, start, nlen):
        """The live entries only, columns in order."""
        gi, _ = _segments(start, nlen)
        return pool[gi], torch.cumsum(nlen, 0) - nlen

    def _holder_segments(self, hold, lo, start, nlen, pool):
        """(mask into ``hold``, segment starts, lengths, edge pool) for the
        holders in the current batch (starting at ``lo``) and for those of
        each earlier, frozen batch."""
        out = []
        cur = hold >= lo
        if bool(cur.any()):
            h = hold[cur] - lo
            out.append((cur, start[h], nlen[h], pool))
        if not bool(cur.all()):
            los = torch.as_tensor([f[0] for f in self.frozen],
                                  device=hold.device)
            j = torch.searchsorted(los, hold, right=True) - 1
            for b in torch.unique(j[~cur]).tolist():
                sel = ~cur & (j == b)
                blo, bstart, blen, bpool = self.frozen[b]
                h = hold[sel] - blo
                out.append((sel, bstart[h], blen[h], bpool))
        return out


def _d1_result(order_c2: torch.Tensor, c1: torch.Tensor,
               pair_edge: torch.Tensor, expansions: int,
               rounds: int) -> SaddleSaddlePairs:
    global_metrics().counter("pairing.d1_rounds").inc(rounds)
    paired = pair_edge >= 0
    pairs = torch.stack([pair_edge[paired], order_c2[paired]], dim=1)
    claimed = torch.isin(c1, pair_edge[paired])
    return SaddleSaddlePairs(pairs, torch.sort(c1[~claimed]).values,
                             order_c2[~paired], expansions, rounds)
