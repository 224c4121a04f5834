"""V-path tracing (paper Sec. IV-A: stable / unstable set computation).

PyTorch counterpart of ``repro.core.tracing``.  The unstable set of a
1-saddle follows vertex->edge vectors down to minima; the stable set of a
(d-1)-saddle follows the dual gradient from its cofacet tets up to maxima.
Both are iterated successor functions, resolved one hop per round
(:func:`resolve_chase`) or by pointer doubling (:func:`resolve_doubling`).
Dead ends on the dual side resolve to the virtual node ``OMEGA``, the
compactified domain boundary.
"""

from __future__ import annotations

import torch

from .gradient import GradientField
from .grid import Grid

OMEGA = -2  # virtual extremum: the compactified domain boundary


def vertex_successors(grid: Grid, gf: GradientField) -> torch.Tensor:
    """(nv,) next vertex along the descending v-path; fixpoint at minima."""
    e = gf.pair_up[0].long()
    v = torch.arange(grid.nv, dtype=torch.int64, device=e.device)
    succ = v.clone()
    paired = e >= 0
    ev = grid.simplex_vertices(1, e[paired])
    succ[paired] = torch.where(ev[:, 0] == v[paired], ev[:, 1], ev[:, 0])
    return succ


def _exit_cofacet(grid: Grid, src: torch.Tensor,
                  tau: torch.Tensor) -> torch.Tensor:
    """The cofacet of each (d-1)-simplex ``tau`` other than ``src``;
    OMEGA where ``tau`` lies on the boundary (single cofacet)."""
    cof = grid.simplex_cofaces(grid.dim - 1, tau)
    other = torch.full_like(src, OMEGA)
    for c in range(cof.shape[1]):
        cc = cof[:, c]
        take = (cc >= 0) & (cc != src) & (other == OMEGA)
        other = torch.where(take, cc, other)
    return other


def tet_successors(grid: Grid, gf: GradientField) -> torch.Tensor:
    """(sid_space(d),) next top simplex along the ascending dual v-path.

    Fixpoint at critical top simplices; OMEGA when the exit facet is on the
    domain boundary.  Only valid sids are meaningful."""
    d = grid.dim
    tau = gf.pair_down[d].long()
    sids = torch.arange(grid.sid_space(d), dtype=torch.int64,
                        device=tau.device)
    succ = sids.clone()
    paired = grid.simplex_valid(d, sids) & (tau >= 0)
    ps = sids[paired]
    succ[ps] = _exit_cofacet(grid, ps, tau[paired])
    return succ


def resolve_chase(succ: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Follow the successor function one hop at a time until fixpoint."""
    cur = starts.clone()
    while True:
        nxt = torch.where(cur >= 0, succ[cur.clamp(min=0)], cur)
        if torch.equal(nxt, cur):
            return cur
        cur = nxt


def resolve_doubling(succ: torch.Tensor) -> torch.Tensor:
    """Pointer doubling: every index to its terminal in O(log L) passes.
    OMEGA entries stay OMEGA."""
    s = succ.clone()
    while True:
        s2 = torch.where(s >= 0, s[s.clamp(min=0)], s)
        if torch.equal(s2, s):
            return s
        s = s2
