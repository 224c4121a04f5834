"""Extremum graph construction (paper Sec. IV, Fig. 5/7).

PyTorch counterpart of ``repro.core.extremum_graph``.  For D0 the nodes
are critical 1-saddles and the minima their unstable sets reach, as
triplets (sigma, t0, t1).  The dual graph of D_{d-1} joins critical
(d-1)-saddles to the critical d-simplices (maxima) their stable sets
reach, with the virtual extremum OMEGA for the compactified boundary:
:func:`build_dual_graph` is the reference's dense version (successors of
every top simplex resolved by pointer doubling, on a host copy);
:func:`repro_torch.kernels.sandwich.build_dual_graph_chase` resolves only
the saddles' cofacets.  Both feed the same elder-rule pairing, processed
oldest saddle first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .critical import CriticalInfo
from .gradient import GradientField, gradient_from_numpy
from .grid import Grid
from .tracing import (OMEGA, resolve_doubling, tet_successors,
                      vertex_successors)


@dataclass
class ExtremumGraph:
    """Triplets sorted by processing order (oldest saddle first).

    saddles:   (n,) saddle sids
    t0, t1:    (n,) extremum node ids (sids, or OMEGA)
    ext_key:   dense map extremum sid -> processing birth key (younger =
               larger); OMEGA is handled symbolically by the pairing.
    """

    saddles: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    ext_key: torch.Tensor


def build_d0_graph(grid: Grid, gf: GradientField,
                   ci: CriticalInfo) -> ExtremumGraph:
    sig = ci.crit_sids[1]  # ascending rank == ascending processing order
    term = resolve_doubling(vertex_successors(grid, gf))
    verts = grid.simplex_vertices(1, sig)
    t0 = term[verts[:, 0]]
    t1 = term[verts[:, 1]]
    keep = t0 != t1
    return ExtremumGraph(sig[keep], t0[keep], t1[keep], ci.order.long())


def build_dual_graph(grid: Grid, gf: GradientField, ci: CriticalInfo,
                     saddles: torch.Tensor) -> ExtremumGraph:
    """Graph for D_{d-1}, as the reference builds it on the host: ``saddles``
    are the critical (d-1)-simplices to process (all of them in 3-D; the
    D0-unpaired ones in 2-D), in descending rank (the superlevel sweep).
    The graph lives on the saddles' device."""
    d = grid.dim
    dev = saddles.device
    host = gradient_from_numpy(grid, *gf.to_numpy(), device="cpu")
    term = resolve_doubling(tet_successors(grid, host)).numpy()
    rank_s = ci.ranks[d - 1].cpu().numpy()
    saddles = saddles.cpu().numpy().astype(np.int64)
    sig = saddles[np.argsort(-rank_s[saddles])]
    cof = (grid.simplex_cofaces(d - 1, torch.from_numpy(sig)).numpy()
           if len(sig) else np.zeros((0, 2), np.int64))
    # a (d-1)-simplex has at most 2 cofacets (a manifold dual edge), but the
    # generic 3-D tables may scatter them across any column: compact them
    t = np.full((len(sig), 2), OMEGA, dtype=np.int64)
    cnt = np.zeros(len(sig), dtype=np.int64)
    for i in range(cof.shape[1] if len(sig) else 0):
        cc = cof[:, i]
        ok = cc >= 0
        if (ok & (cnt >= 2)).any():
            raise ValueError("non-manifold cofacet count")
        put0 = ok & (cnt == 0)
        put1 = ok & (cnt == 1)
        t[put0, 0] = term[cc[put0]]
        t[put1, 1] = term[cc[put1]]
        cnt += ok
    keep = t[:, 0] != t[:, 1]

    def conv(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    # processing key: reversed rank (younger in superlevel = smaller rank)
    return ExtremumGraph(conv(sig[keep]), conv(t[keep, 0]), conv(t[keep, 1]),
                         -ci.ranks[d])
