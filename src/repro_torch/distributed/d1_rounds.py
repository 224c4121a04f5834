"""Distributed saddle-saddle pairing (paper Sec. V, Alg. 5/6): the
token-based round-synchronous engine with the global-local boundary.

A host copy of ``repro.distributed.d1_rounds`` for the port: it reads
``gf.pair_up[1]``, the edge keys and the triangle ranks to the host once
and runs the reference's schedule on Python sets, so its pairs and every
statistic (rounds, token hops, expansions, merges, steals, addition
messages) equal the reference's.  A tensor form of the token engine for
the card is still to come.

Structure (paper -> here):

- *global-local boundary*: per block, the set of boundary edges it owns
  (``local``), plus the (n_props, n_blocks) table of the highest boundary
  edge key per block (``gmax``) — the "global boundary";
- *computation token*: ``owner[i]`` — only that block expands propagation
  i this round; tokens travel to the block holding the global max edge;
- *anticipation* (Sec. V-B): the owner keeps expanding locally up to
  ``budget`` steps even while the global max is remote, but never pairs
  or steals an edge unless its key dominates every remote column;
- *self-correction* (Alg. 5 l.20-27): reaching an edge already paired to
  an older propagation merges boundaries; an older propagation steals the
  edge from a younger one, which is reactivated;
- messages (edge additions, merge broadcasts, token transfers) are
  applied at round boundaries in a fixed order.  ``gmax`` columns may
  overestimate after merges; a token arriving at a block whose true max
  is lower corrects the column and moves on.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.critical import CriticalInfo
from repro_torch.core.gradient import GradientField
from repro_torch.core.grid import NTYPES, Grid
from repro_torch.core.saddle_saddle import SaddleSaddlePairs, _tri_boundary
from repro_torch.obs import watchdog as _watchdog
from repro_torch.obs.metrics import global_metrics
from repro_torch.obs.trace import current_trace, maybe_span

NEG_INF = -(2 ** 62)
# edge-space size up to which the host tables are Python lists (fast
# element reads); larger spaces stay numpy arrays
_LIST_LIMIT = 1 << 24


@dataclass
class D1Stats:
    rounds: int = 0
    token_hops: int = 0
    expansions: int = 0
    merges: int = 0
    steals: int = 0
    addition_msgs: int = 0


def edge_keys_packed(grid: Grid, order) -> np.ndarray:
    """Dense packed lexicographic key per edge sid, ``o_max * 2^31 +
    o_min`` (NEG_INF on invalid sids), on the host."""
    o = torch.as_tensor(np.asarray(order)).long()
    sids = torch.arange(grid.sid_space(1), dtype=torch.int64)
    valid = grid.simplex_valid(1, sids)
    keys = torch.full_like(sids, NEG_INF)
    ov = o[grid.simplex_vertices(1, sids[valid])]
    keys[sids[valid]] = (torch.maximum(ov[:, 0], ov[:, 1]) << 31) \
        + torch.minimum(ov[:, 0], ov[:, 1])
    return keys.numpy()


class _Block:
    """Per-block state (one MPI rank / device)."""

    def __init__(self, bid: int):
        self.bid = bid
        self.local: Dict[int, Set[int]] = {}          # prop -> owned edges
        self.pair_of_edge: Dict[int, int] = {}        # owned edge -> prop
        self.inbox_add: List[Tuple[int, int]] = []    # (prop, edge sid)
        self.inbox_merge: List[Tuple[int, int]] = []  # (dst prop, src prop)

    def toggle(self, prop: int, e: int):
        s = self.local.setdefault(prop, set())
        if e in s:
            s.remove(e)
        else:
            s.add(e)

    def local_max(self, prop: int, ekey) -> int:
        s = self.local.get(prop)
        if not s:
            return NEG_INF
        return max(int(ekey[e]) for e in s)


def _host(t, as_list: bool = True):
    """``t`` on the host: a Python list when ``as_list`` and it is small
    enough (fast element reads), else a numpy array."""
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.tolist() if as_list and a.size <= _LIST_LIMIT else a


def _argmax(row: List[int]) -> int:
    """Index of the first maximum (``np.argmax``)."""
    return max(range(len(row)), key=row.__getitem__)


def d1_distributed(grid: Grid, gf: GradientField, ci: CriticalInfo,
                   c1, c2, n_blocks: int, anticipation: bool = True,
                   budget: Optional[int] = None
                   ) -> Tuple[SaddleSaddlePairs, D1Stats]:
    """Block-parallel D1 over ``n_blocks`` z-slabs.  ``c1``: unpaired
    critical edges, ``c2``: unpaired critical triangles (tensors or
    arrays).  ``budget`` = anticipation steps per round (default: 0.01 %
    of the local triangles, at least 1); ``anticipation=False`` is the
    paper's *Basic* version (Sec. V-A).  Returns the pairs as tensors on
    the gradient's device and the reference's statistics."""
    if grid.dim != 3:
        raise ValueError(f"distributed D1 is a 3-D procedure, got a "
                         f"{grid.dim}-D grid {grid.dims}")
    dev = gf.pair_up[1].device
    stats = D1Stats()
    nx, ny, nz = grid.dims
    zsplit = np.linspace(0, nz, n_blocks + 1).astype(int).tolist()
    plane = nx * ny

    def block_of_vertex(v: int) -> int:
        return bisect.bisect_right(zsplit, v // plane) - 1

    def block_of_edge(e: int) -> int:
        return block_of_vertex(e // NTYPES[1])

    def block_of_tri(t: int) -> int:
        return block_of_vertex(t // NTYPES[2])

    # edge keys are compared, never decoded: the (o_max, o_min) packing
    # needs orders < 2^31; the dense edge ranks sort identically
    order = ci.order.reshape(-1)
    if order.numel() and int(order.max()) < 2 ** 31:
        ekey = _host(edge_keys_packed(grid, order.cpu()))
    else:
        ekey = _host(ci.ranks[1])
    trank = _host(ci.ranks[2])
    pair_up1 = _host(gf.pair_up[1])
    c1_set = {int(x) for x in _host(c1, as_list=False)}
    c2 = sorted((int(x) for x in _host(c2, as_list=False)),
                key=lambda s: int(trank[s]))
    n2 = len(c2)
    if budget is None:
        budget = max(1, grid.n_simplices(2) // (10000 * n_blocks))

    blocks = [_Block(b) for b in range(n_blocks)]
    gmax = [[NEG_INF] * n_blocks for _ in range(n2)]
    owner = [block_of_tri(s) for s in c2]
    active = [True] * n2
    pair_edge = [-1] * n2

    # initial boundaries (boundary of sigma): additions routed to owners
    for i, s in enumerate(c2):
        for e in _tri_boundary(grid, s):
            b = block_of_edge(e)
            blocks[b].inbox_add.append((i, e))
            gmax[i][b] = max(gmax[i][b], int(ekey[e]))

    def expand(i: int, blk: _Block) -> Optional[Tuple[int, str]]:
        """Run propagation i at its token owner.  Returns (dest, why) if
        the token must move, None if the propagation retired this round."""
        steps = 0
        row = gmax[i]
        while True:
            lmax = blk.local_max(i, ekey)
            rmax_col = max(v for b, v in enumerate(row) if b != blk.bid) \
                if n_blocks > 1 else NEG_INF
            row[blk.bid] = lmax
            if lmax == NEG_INF and rmax_col == NEG_INF:
                active[i] = False          # boundary vanished: essential
                return None
            if lmax == NEG_INF or (not anticipation and lmax < rmax_col):
                return (_argmax(row), "basic")
            if steps >= budget and lmax < rmax_col:
                return (_argmax(row), "budget")
            tau = max(blk.local.get(i, ()), key=lambda e: int(ekey[e]))
            up = int(pair_up1[tau])
            if up >= 0:
                # triangle-paired: XOR the apparent pair's boundary; legal
                # even when a remote column dominates (XOR commutes)
                stats.expansions += 1
                steps += 1
                for e in _tri_boundary(grid, up):
                    b = block_of_edge(e)
                    if b == blk.bid:
                        blk.toggle(i, e)
                    else:
                        blocks[b].inbox_add.append((i, e))
                        row[b] = max(row[b], int(ekey[e]))
                        stats.addition_msgs += 1
                continue
            if int(ekey[tau]) < rmax_col:
                # the local max is not the cycle max: it may be a negative
                # edge the true max's expansions will cancel — pause
                return (_argmax(row), "defer-pair")
            # tau dominates globally: the max edge of a 1-cycle is
            # positive, so a critical tau is D0-unpaired
            assert tau in c1_set, "negative edge dominates a 1-cycle"
            j = blk.pair_of_edge.get(tau, -1)
            if j < 0:
                blk.pair_of_edge[tau] = i
                pair_edge[i] = tau
                active[i] = False          # token parks here
                return None
            if trank[c2[j]] < trank[c2[i]]:
                # tau belongs to an older propagation: merge its boundary
                stats.merges += 1
                for b in range(n_blocks):
                    if b == blk.bid:
                        for e in list(blocks[b].local.get(j, ())):
                            blk.toggle(i, e)
                    else:
                        blocks[b].inbox_merge.append((i, j))
                    row[b] = max(row[b], gmax[j][b])
                continue
            # steal: i is older — tau re-pairs with i, j resumes here
            stats.steals += 1
            blk.pair_of_edge[tau] = i
            pair_edge[i] = tau
            pair_edge[j] = -1
            active[j] = True
            owner[j] = blk.bid
            active[i] = False
            return None

    tr = current_trace()   # grabbed once: the loop runs on one thread
    while True:
        stats.rounds += 1
        _watchdog.progress("pairing.d1")    # round heartbeat
        with maybe_span(tr, "d1_round", round=stats.rounds):
            # ---- apply messages (fixed order), refresh gmax -------------
            for blk in blocks:
                touched = set()
                for i, e in blk.inbox_add:
                    blk.toggle(i, e)
                    touched.add(i)
                blk.inbox_add = []
                for i, j in blk.inbox_merge:
                    for e in list(blk.local.get(j, ())):
                        blk.toggle(i, e)
                    touched.add(i)
                blk.inbox_merge = []
                for i in touched:
                    gmax[i][blk.bid] = blk.local_max(i, ekey)
            # ---- token owners expand (ownership snapshot: transfers take
            # effect next round; boundary updates come before tokens) ----
            moved = False
            owner_snapshot = list(owner)
            active_snapshot = list(active)
            for blk in blocks:
                for i in range(n2):
                    if active_snapshot[i] and owner_snapshot[i] == blk.bid:
                        res = expand(i, blk)
                        if res is not None:
                            dest, _ = res
                            if dest != blk.bid:
                                stats.token_hops += 1
                                moved = True
                            owner[i] = dest
        if not any(active):
            break
        if not moved:
            # every active propagation waits on messages applied next
            # round; with none in flight either, the rounds are stuck
            in_flight = any(blk.inbox_add or blk.inbox_merge
                            for blk in blocks)
            if not in_flight:
                assert any(active[i] and owner[i] == blk.bid
                           for blk in blocks for i in range(n2)), \
                    "D1 rounds deadlocked"
    global_metrics().counter("pairing.d1_rounds").inc(stats.rounds)

    pairs = []
    for blk in blocks:
        for e, i in blk.pair_of_edge.items():
            if pair_edge[i] == e:
                pairs.append((int(e), int(c2[i])))
    pairs.sort()
    paired_edges = {e for e, _ in pairs}
    paired_tris = {t for _, t in pairs}

    def tensor(x, shape=(-1,)):
        return torch.as_tensor(np.asarray(x, dtype=np.int64).reshape(shape),
                               device=dev)
    return SaddleSaddlePairs(
        tensor(pairs, (-1, 2)), tensor(sorted(c1_set - paired_edges)),
        tensor(sorted(set(c2) - paired_tris)), stats.expansions,
        stats.rounds), stats
