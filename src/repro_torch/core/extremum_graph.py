"""Extremum graph construction (paper Sec. IV, Fig. 5/7).

PyTorch counterpart of ``repro.core.extremum_graph``.  For D0 the nodes
are critical 1-saddles and the minima their unstable sets reach, as
triplets (sigma, t0, t1); the dual graph of D_{d-1} is built by
:func:`repro_torch.kernels.sandwich.build_dual_graph_chase`.  Both feed
the same elder-rule pairing, processed oldest saddle first.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .critical import CriticalInfo
from .gradient import GradientField
from .grid import Grid
from .tracing import resolve_doubling, vertex_successors


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
