"""Plain PyTorch reference of what the port's front-end and D0 return.

It reads a 3-D float32 field and works out, on its own and with torch
operations and plain Python only (it imports nothing of the program under
test):

- the vertex order: the rank of each vertex by (value, vertex id);
- the critical cells of each dimension at each vertex, from the
  topology of its lower link (the induced subcomplex, on the lower
  neighbours, of the 14-vertex link sphere of the Freudenthal
  triangulation): a minimum where the lower link is empty, one critical
  edge per lower-link component beyond the first, b1 critical
  triangles and b2 critical tets.  A lower-star gradient that is
  perfect in 3-D (Robins, Wood and Sheppard, 2011) has exactly these;
  the critical edge of a component joins the vertex to that component's
  lowest neighbour;
- every vertex's steepest descent (to its lowest lower neighbour), and
  the minimum it ends at;
- the D0 diagram by the elder rule: the critical edges, in the order of
  their (upper, lower) vertex ranks, merge the basins of the minima they
  join, and at each merge the younger minimum dies;
- for single vertices, the whole lower-star pairing (ProcessLowerStars,
  in its queue-free form) over the 74 simplices of the vertex's star, in
  the packed row layout below, and from it ascending dual paths through
  the tets.

Simplex ids follow the grid's dense convention: a k-simplex is a chain
x, x + p1, x + p1 + p2, ... of disjoint nonzero 0/1 offsets (dx, dy, dz);
its types are those chains in ``itertools.product`` order (7 edges, 12
triangles, 6 tets), its base the chain's first vertex, and its id
``base * T_k + type``.  An edge's type is ``4 dx + 2 dy + dz - 1``.  The
star of a vertex is packed in 74 rows: for k = 1, 2, 3 (from row 0, 14,
50), each type t and each position j of the vertex in its chain, row
``t (k + 1) + j``.

Everything on whole grids runs on the device of the field, in z-slabs
where a whole grid of per-vertex work would not fit beside the rest.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

# the 7 positive offsets (dx, dy, dz) of the Freudenthal triangulation, in
# edge-type order, and the 14 neighbours: those offsets, then their negatives
POS = [p for p in itertools.product((0, 1), repeat=3) if any(p)]
NBRS = POS + [tuple(-c for c in p) for p in POS]
_NB_INDEX = {p: j for j, p in enumerate(NBRS)}


def _add(*vs):
    return tuple(sum(c) for c in zip(*vs))


def _neg(v):
    return tuple(-c for c in v)


def _link() -> Tuple[list, list]:
    """The link of a vertex: its edges (pairs of neighbour slots) and its
    triangles (triples), from the simplices of the triangulation that
    hold the vertex.  A k-simplex is a chain x, x + p1, x + p1 + p2, ...
    of disjoint nonzero 0/1 offsets; the vertex can be any of its
    corners."""
    edges, tris = set(), set()
    for k, out in ((2, edges), (3, tris)):
        for parts in itertools.product(POS, repeat=k):
            tot = _add(*parts)
            if max(tot) > 1:
                continue
            chain = [(0, 0, 0)]
            for p in parts:
                chain.append(_add(chain[-1], p))
            for j in range(k + 1):
                rel = [_add(c, _neg(chain[j])) for i, c in enumerate(chain)
                       if i != j]
                out.add(tuple(sorted(_NB_INDEX[r] for r in rel)))
    return sorted(edges), sorted(tris)


LINK_EDGES, LINK_TRIS = _link()
FULL = (1 << 14) - 1


def _tables():
    """Per lower-neighbour mask (14 bits): (b0, b1, b2) of the induced
    lower link, and each neighbour's component index (-1 off the mask)."""
    betti = np.zeros((FULL + 1, 3), np.int8)
    comp = np.full((FULL + 1, 14), -1, np.int8)
    for m in range(1, FULL + 1):
        inl = [(m >> j) & 1 for j in range(14)]
        par = list(range(14))

        def find(a):
            while par[a] != a:
                par[a] = par[par[a]]
                a = par[a]
            return a
        ne = 0
        for a, b in LINK_EDGES:
            if inl[a] and inl[b]:
                ne += 1
                ra, rb = find(a), find(b)
                if ra != rb:
                    par[max(ra, rb)] = min(ra, rb)
        nt = sum(1 for a, b, c in LINK_TRIS if inl[a] and inl[b] and inl[c])
        labels: Dict[int, int] = {}
        for j in range(14):
            if inl[j]:
                comp[m, j] = labels.setdefault(find(j), len(labels))
        b0 = len(labels)
        b2 = 1 if m == FULL else 0
        chi = sum(inl) - ne + nt
        betti[m] = (b0, b0 - chi + b2, b2)
    return betti, comp


_TABLES = {}


def tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lower-link tables on ``device`` (built once per process)."""
    if "np" not in _TABLES:
        _TABLES["np"] = _tables()
    key = str(device)
    if key not in _TABLES:
        b, c = _TABLES["np"]
        _TABLES[key] = (torch.as_tensor(b, dtype=torch.int64, device=device),
                        torch.as_tensor(c, dtype=torch.int64, device=device))
    return _TABLES[key]


def sortable_bits(f: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the order of the float32 values ``f``
    (-0.0 and +0.0 equal; no NaN)."""
    b = (f.reshape(-1).float() + 0.0).view(torch.int32).long()
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def vertex_ranks(f: torch.Tensor) -> torch.Tensor:
    """Rank of each vertex by (value, vertex id), int64."""
    n = f.numel()
    key = sortable_bits(f) * n + torch.arange(n, device=f.device)
    perm = torch.sort(key).indices
    del key
    rank = torch.empty(n, dtype=torch.int64, device=f.device)
    rank[perm] = torch.arange(n, device=f.device)
    return rank


def _padded(rank: torch.Tensor, dims) -> torch.Tensor:
    """int32 ranks as a (nz+2, ny+2, nx+2) volume, outside the grid
    higher than every vertex."""
    nx, ny, nz = dims
    n = nx * ny * nz
    vol = torch.full((nz + 2, ny + 2, nx + 2), n, dtype=torch.int32,
                     device=rank.device)
    vol[1:-1, 1:-1, 1:-1] = rank.reshape(nz, ny, nx)
    return vol


def _slab_nbrs(vol: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
    """(14, z1 - z0, ny, nx) neighbour ranks of planes [z0, z1)."""
    _, nyp, nxp = vol.shape
    ny, nx = nyp - 2, nxp - 2
    return torch.stack([vol[1 + z0 + dz:1 + z1 + dz, 1 + dy:1 + dy + ny,
                            1 + dx:1 + dx + nx] for dx, dy, dz in NBRS])




# ---------------------------------------------------------------------------
# simplex types and the packed star rows
# ---------------------------------------------------------------------------

def _chains(k: int) -> list:
    out = []
    for parts in itertools.product(POS, repeat=k):
        if max(_add(*parts)) > 1:
            continue
        chain = [(0, 0, 0)]
        for p in parts:
            chain.append(_add(chain[-1], p))
        out.append(chain)
    return out


VERTS = {k: _chains(k) for k in (1, 2, 3)}
NTYPES = {0: 1, 1: 7, 2: 12, 3: 6}
ROW_OFF = {1: 0, 2: 14, 3: 50}
NROWS = 74
NOT_L, AVAIL, TAIL, HEAD, CRIT = 0, 1, 2, 3, 4
OMEGA = -2          # an ascending path that leaves the grid


def _rows():
    """Per packed row: (k, type, position of the vertex, the other
    vertices' offsets from it)."""
    rows = []
    for k in (1, 2, 3):
        for t, chain in enumerate(VERTS[k]):
            for j in range(k + 1):
                rows.append((k, t, j, tuple(_add(c, _neg(chain[j]))
                                            for i, c in enumerate(chain)
                                            if i != j)))
    return rows


ROWS = _rows()
_ROW_OF = {frozenset(r[3]): i for i, r in enumerate(ROWS)}
# the faces of each row that hold the vertex, as rows
FACE_ROWS = [[_ROW_OF[frozenset(o for o in r[3] if o != drop)]
              for drop in r[3]] if r[0] > 1 else [] for r in ROWS]


def edge_row(slot: torch.Tensor) -> torch.Tensor:
    """The packed row of the edge from a vertex to its neighbour slot."""
    return torch.where(slot < 7, 2 * slot, 2 * (slot - 7) + 1)


def row_offsets(device) -> torch.Tensor:
    """(74, 3, 3) offsets (dx, dy, dz) of each row's other vertices,
    padded with zeros, and ``(74,)`` their count is ``k``."""
    tab = torch.zeros((NROWS, 3, 3), dtype=torch.int64)
    for i, (_, _, _, oth) in enumerate(ROWS):
        for m, o in enumerate(oth):
            tab[i, m] = torch.tensor(o)
    return tab.to(device)


def _triangle_cofacets():
    """Per triangle type: the (tet type, base shift) of the tets holding
    it, in the order of tet type, then of the vertex the tet drops."""
    out = {t: [] for t in range(NTYPES[2])}
    tri_of = {tuple(c): t for t, c in enumerate(VERTS[2])}
    for tt, chain in enumerate(VERTS[3]):
        for d in range(4):
            face = [c for i, c in enumerate(chain) if i != d]
            rel = tuple(_add(c, _neg(face[0])) for c in face)
            out[tri_of[rel]].append((tt, face[0]))
    return out


TRI_COFACETS = _triangle_cofacets()


def simplex_vertices(sid: torch.Tensor, k: int, dims) -> torch.Tensor:
    """(n, k + 1) vertex ids of the k-simplices ``sid``."""
    nx, ny, _ = dims
    chains = torch.as_tensor(VERTS[k], dtype=torch.int64, device=sid.device)
    base, t = sid // NTYPES[k], sid % NTYPES[k]
    off = chains[t]                                   # (n, k+1, 3)
    step = torch.tensor([1, nx, nx * ny], device=sid.device)
    return base[:, None] + (off * step).sum(-1)


# ---------------------------------------------------------------------------
# whole grids
# ---------------------------------------------------------------------------

def _edge_sid(v: torch.Tensor, j: torch.Tensor, dims) -> torch.Tensor:
    nx, ny, _ = dims
    nb = torch.as_tensor(NBRS, dtype=torch.int64, device=v.device)[j]
    neg = j >= 7
    base = v + torch.where(neg, nb[:, 0] + nx * (nb[:, 1] + ny * nb[:, 2]),
                           torch.zeros_like(v))
    t = torch.where(neg, j - 7, j)
    return base * 7 + t


def _offsets(dims, device) -> torch.Tensor:
    """The vertex-id offset of each neighbour slot."""
    nx, ny, _ = dims
    return torch.as_tensor([dx + nx * (dy + ny * dz) for dx, dy, dz in NBRS],
                           device=device)


def lower_link(rank: torch.Tensor, dims, slab: int = 32):
    """Per vertex: the 14-bit mask of lower neighbours and the slot of the
    lowest of them (-1 at a minimum)."""
    nx, ny, nz = dims
    dev = rank.device
    vol = _padded(rank, dims)
    mask = torch.empty(nz * ny * nx, dtype=torch.int64, device=dev)
    low = torch.empty(nz * ny * nx, dtype=torch.int8, device=dev)
    bits = (1 << torch.arange(14, device=dev)).view(14, 1, 1, 1)
    for z0 in range(0, nz, slab):
        z1 = min(nz, z0 + slab)
        nb = _slab_nbrs(vol, z0, z1)
        own = vol[1 + z0:1 + z1, 1:-1, 1:-1]
        below = nb < own
        lo, hi = z0 * nx * ny, z1 * nx * ny
        mask[lo:hi] = (below.long() * bits).sum(0).reshape(-1)
        m = torch.where(below, nb, torch.iinfo(torch.int32).max).min(0)
        low[lo:hi] = torch.where(m.values.reshape(-1) < own.reshape(-1),
                                 m.indices.reshape(-1), -1).to(torch.int8)
        del nb, below, m
    return vol, mask, low


def saddle_edges(vol: torch.Tensor, mask: torch.Tensor,
                 comp_tab: torch.Tensor, verts: torch.Tensor, dims):
    """The critical edges of the vertices ``verts`` (those whose lower link
    has two components or more): (upper vid, neighbour slot) for each
    component but the one that holds the lowest neighbour."""
    nx, ny, _ = dims
    x, y, z = verts % nx, (verts // nx) % ny, verts // (nx * ny)
    nb = torch.stack([vol[z + 1 + dz, y + 1 + dy, x + 1 + dx].long()
                      for dx, dy, dz in NBRS], dim=1)
    comp = comp_tab[mask[verts]]                      # (S, 14)
    big = torch.iinfo(torch.int64).max
    lowest = torch.where(comp >= 0, nb, big).argmin(1)
    first = comp.gather(1, lowest[:, None])[:, 0]
    vs, js = [], []
    for c in range(int(comp.max()) + 1 if len(verts) else 0):
        r = torch.where(comp == c, nb, big)
        rmin, j = r.min(1)
        keep = (rmin < big) & (first != c)
        vs.append(verts[keep])
        js.append(j[keep])
    if not vs:
        e = torch.zeros(0, dtype=torch.int64, device=verts.device)
        return e, e
    return torch.cat(vs), torch.cat(js)


@dataclass
class Front:
    """What the lower links of a field fix, on the field's device."""

    rank: torch.Tensor          # (nv,) int64
    mask: torch.Tensor          # (nv,) int64, 14-bit lower-neighbour mask
    crit: torch.Tensor          # (nv, 3) int8: critical edges, triangles
    #                             and tets in the vertex's lower star
    low: torch.Tensor           # (nv,) int8 slot of the lowest lower
    #                             neighbour, -1 at a minimum
    root: torch.Tensor          # (nv,) int64 minimum of the steepest descent
    sv: torch.Tensor            # critical edges: upper vid, ascending,
    sj: torch.Tensor            # and neighbour slot, by row within a vertex

    @property
    def minima(self) -> torch.Tensor:
        return torch.nonzero(self.mask == 0).reshape(-1)

    def n_critical(self) -> Dict[int, int]:
        c = self.crit.sum(0, dtype=torch.int64).tolist()
        return {0: int((self.mask == 0).sum()), 1: c[0], 2: c[1], 3: c[2]}


def front_reference(f: torch.Tensor, dims) -> Front:
    """The order, the critical cells at each vertex, the critical edges
    and the steepest descent of the field ``f`` (flat, x fastest) on the
    grid ``dims`` = (nx, ny, nz)."""
    n = f.numel()
    dev = f.device
    rank = vertex_ranks(f)
    betti, comp_tab = tables(dev)
    vol, mask, low = lower_link(rank, dims)
    crit = torch.empty((n, 3), dtype=torch.int8, device=dev)
    step = 1 << 24
    for a in range(0, n, step):
        b = betti[mask[a:a + step]]
        crit[a:a + step, 0] = (b[:, 0] - 1).clamp(min=0)
        crit[a:a + step, 1:] = b[:, 1:]
    multi = torch.nonzero(crit[:, 0] > 0).reshape(-1)
    sv, sj = saddle_edges(vol, mask, comp_tab, multi, dims)
    del vol, multi
    o = torch.argsort(sv * NROWS + edge_row(sj))
    sv, sj = sv[o], sj[o]
    # steepest descent to the minima, by pointer doubling
    vid = torch.arange(n, device=dev)
    lowl = low.long()
    root = torch.where(lowl >= 0, vid + _offsets(dims, dev)[lowl.clamp(min=0)],
                       vid)
    del vid, lowl
    while True:
        nxt = root[root]
        if torch.equal(nxt, root):
            break
        root = nxt
    return Front(rank, mask, crit, low, root, sv, sj)


def elder_rule(n_nodes: int, a: torch.Tensor, b: torch.Tensor,
               max_rounds: int = 200):
    """Kruskal's merges of ``n_nodes`` nodes (index = age, 0 oldest) by the
    edges ``(a[i], b[i])`` taken in index order; at each merge the younger
    group's oldest node dies.  Returns ``(death, rounds)``: ``death[node]``
    the index of the edge that killed it, -1 if none.

    In rounds on the device: every group whose first edge (the lightest
    it touches) leads to a group with an older node dies at that edge and
    joins that group.  Its oldest node reaches the edge's near end over
    lighter edges, and the far group's oldest node over lighter ones
    again, so no path out of the group reaches an older node over a
    lighter edge; and every later path through the group comes in over a
    heavier edge than any inside it.  Edges inside a group go.  The
    global first edge always qualifies, so each round joins a group."""
    dev = a.device
    death = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    label = torch.arange(n_nodes, device=dev)
    pos = torch.arange(len(a), device=dev)
    big = torch.iinfo(torch.int64).max
    rounds = 0
    while len(pos):
        if rounds == max_rounds:
            raise RuntimeError(f"elder rule: {len(pos)} edges left after "
                               f"{rounds} rounds")
        rounds += 1
        la, lb = label[a], label[b]
        keep = la != lb
        a, b, pos, la, lb = a[keep], b[keep], pos[keep], la[keep], lb[keep]
        if len(pos) == 0:
            break
        first = torch.full((n_nodes,), big, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, la, pos, "amin")
        first.scatter_reduce_(0, lb, pos, "amin")
        g = torch.nonzero(first < big).reshape(-1)
        i = torch.searchsorted(pos, first[g])
        other = torch.where(la[i] == g, lb[i], la[i])
        dies = other < g
        g, other = g[dies], other[dies]
        death[g] = first[g]
        into = torch.arange(n_nodes, device=dev)
        into[g] = other
        while True:
            nxt = into[into]
            if torch.equal(nxt, into):
                break
            into = nxt
        label = into[label]
    return death, rounds




@dataclass
class D0Reference:
    """What a D0 request must return."""

    rank: torch.Tensor          # (nv,) int64
    n_critical: Dict[int, int]  # critical cells per dimension
    pairs: torch.Tensor         # (n, 2) int64 (minimum vid, edge sid), sorted
    essential: torch.Tensor     # (m,) int64 minimum vids
    rounds: int = 0             # rounds of the elder rule


def d0_pairs(fr: Front, dims) -> D0Reference:
    """The D0 diagram of a field from its :class:`Front`."""
    n = fr.rank.numel()
    dev = fr.rank.device
    mins = fr.minima
    mins = mins[torch.argsort(fr.rank[mins])]        # oldest first
    node = torch.full((n,), -1, dtype=torch.int64, device=dev)
    node[mins] = torch.arange(len(mins), device=dev)
    su = fr.sv + _offsets(dims, dev)[fr.sj]
    o = torch.argsort(fr.rank[fr.sv] * n + fr.rank[su])
    sv, sj, su = fr.sv[o], fr.sj[o], su[o]
    na, nb_ = node[fr.root[sv]], node[fr.root[su]]
    del node
    death, rounds = elder_rule(len(mins), na, nb_)
    dead = torch.nonzero(death >= 0).reshape(-1)
    e = death[dead]
    pairs = torch.stack([mins[dead], _edge_sid(sv[e], sj[e], dims)], 1)
    pairs = pairs[torch.argsort(pairs[:, 0])]
    essential = torch.sort(mins[death < 0]).values
    return D0Reference(fr.rank, fr.n_critical(), pairs, essential, rounds)


def d0_reference(f: torch.Tensor, dims) -> D0Reference:
    """The order, critical counts and D0 diagram of the field ``f``."""
    return d0_pairs(front_reference(f, dims), dims)


# ---------------------------------------------------------------------------
# single vertices: the lower-star pairing and ascending dual paths
# ---------------------------------------------------------------------------

class Stars:
    """ProcessLowerStars on single vertices of a grid whose vertex ranks
    are ``rank`` (a flat numpy array, x fastest), memoised.

    The queue-free form: the vertex pairs with its lowest edge; then, as
    long as some available simplex of the lower star has exactly one
    available face that holds the vertex, the lowest such simplex (by the
    ranks of its other vertices, highest first) pairs with that face;
    when none has, the lowest available simplex with no available face
    is critical.  A simplex is lower when every other vertex of it is
    inside the grid and ranked below the vertex."""

    def __init__(self, rank, dims):
        self.rank = rank
        self.dims = tuple(int(d) for d in dims)
        self._memo: Dict[int, tuple] = {}

    def _rank_at(self, v: int, off) -> int:
        nx, ny, nz = self.dims
        x, y, z = v % nx + off[0], (v // nx) % ny + off[1], \
            v // (nx * ny) + off[2]
        if not (0 <= x < nx and 0 <= y < ny and 0 <= z < nz):
            return -1
        return int(self.rank[x + nx * (y + ny * z)])

    def pairing(self, v: int):
        """(status, partner, vstat, vpart) of vertex ``v``: status and
        partner over its 74 rows (partner: a row, -2 for the vertex, -1
        for none), vstat and vpart the vertex's own."""
        if v in self._memo:
            return self._memo[v]
        rv = int(self.rank[v])
        nb = {o: self._rank_at(v, o) for o in NBRS}
        status = [NOT_L] * NROWS
        partner = [-1] * NROWS
        key = {}
        for i, (_, _, _, oth) in enumerate(ROWS):
            rs = [nb[o] for o in oth]
            if all(0 <= r < rv for r in rs):
                status[i] = AVAIL
                key[i] = tuple(sorted(rs, reverse=True)) + (-1,) * (3 - len(rs))
        edges = [i for i in key if i < 14]
        if not edges:
            out = (status, partner, CRIT, -1)
            self._memo[v] = out
            return out
        delta = min(edges, key=key.__getitem__)
        status[delta], partner[delta] = HEAD, -2
        lower = sorted(key, key=key.__getitem__)
        while True:
            one = zero = None
            for i in lower:
                if status[i] != AVAIL:
                    continue
                free = [fr for fr in FACE_ROWS[i] if status[fr] == AVAIL]
                if len(free) == 1:
                    one = (i, free[0])
                    break
                if not free and zero is None:
                    zero = i
            if one is not None:
                i, face = one
                status[i], partner[i] = HEAD, face
                status[face], partner[face] = TAIL, i
            elif zero is not None:
                status[zero] = CRIT
            else:
                break
        out = (status, partner, TAIL, delta)
        self._memo[v] = out
        return out

    def _vid(self, base: int, off) -> int:
        nx, ny, _ = self.dims
        return base + off[0] + nx * (off[1] + ny * off[2])

    def _inside(self, base: int, span) -> bool:
        nx, ny, nz = self.dims
        x, y, z = base % nx, (base // nx) % ny, base // (nx * ny)
        return x + span[0] < nx and y + span[1] < ny and z + span[2] < nz

    def triangle_cofacets(self, v: int, row: int) -> list:
        """The tets (sids) holding the triangle of ``v``'s star row
        ``row``, in the order of tet type, then of the vertex the tet
        drops."""
        _, t, j, _ = ROWS[row]
        nx, ny, nz = self.dims
        tb = v - self._vid(0, VERTS[2][t][j])
        out = []
        for tt, shift in TRI_COFACETS[t]:
            x = tb % nx - shift[0]
            y = (tb // nx) % ny - shift[1]
            z = tb // (nx * ny) - shift[2]
            if min(x, y, z) < 0:
                continue
            base = x + nx * (y + ny * z)
            if self._inside(base, VERTS[3][tt][-1]):
                out.append(base * NTYPES[3] + tt)
        return out

    def ascend(self, tet: int, limit: int = 1 << 20) -> int:
        """The critical tet that the ascending dual path from ``tet`` ends
        at, or OMEGA where it leaves the grid."""
        for _ in range(limit):
            if tet < 0:
                return OMEGA
            base, tt = divmod(tet, NTYPES[3])
            vs = [self._vid(base, c) for c in VERTS[3][tt]]
            j = max(range(4), key=lambda i: int(self.rank[vs[i]]))
            w = vs[j]
            row = ROW_OFF[3] + tt * 4 + j
            status, partner, _, _ = self.pairing(w)
            if status[row] == CRIT:
                return tet
            if status[row] != HEAD:
                raise AssertionError(f"tet {tet}: status {status[row]} in "
                                     f"the lower star of {w}")
            nxt = [c for c in self.triangle_cofacets(w, partner[row])
                   if c != tet]
            tet = nxt[0] if nxt else OMEGA
        raise RuntimeError(f"ascending path from {tet} longer than {limit}")


def set_difference(x: torch.Tensor, y: torch.Tensor) -> int:
    """How many values lie in one of ``x`` and ``y`` and not the other."""
    x, y = torch.unique(x), torch.unique(y)
    return int(len(x) + len(y) - 2 * torch.isin(x, y).sum())
