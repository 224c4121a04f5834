"""Saddle-saddle pairs (D1, paper Sec. II-F), as tensors.

PyTorch counterpart of ``repro.core.saddle_saddle``.
:func:`pair_saddle_saddle_seq` is the reference's sequential homologous
propagation on the host: for each unpaired critical triangle sigma in
ascending filtration order, the boundary 1-cycle B (a Python set of edge
sids) is expanded by its highest edge tau — B ^= boundary(t) when tau is
gradient-paired with a triangle t, B ^= the stored boundary of sigma'
when tau is already paired to an older sigma' (merge) — until tau is an
unpaired critical edge, which pairs with sigma.  The batched reductions
are :func:`repro_torch.kernels.sandwich.pair_saddle_saddle_wavefront` and
the distributed token engine :func:`repro_torch.distributed.d1_rounds
.d1_distributed`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

import torch

from .critical import CriticalInfo
from .gradient import GradientField
from .grid import FACES, NTYPES, Grid


@dataclass
class SaddleSaddlePairs:
    pairs: torch.Tensor               # (n, 2) (edge sid birth, triangle death)
    unpaired_edges: torch.Tensor      # essential H1 generators, ascending
    unpaired_triangles: torch.Tensor  # essential H2 feed (empty on a box)
    expansions: int = 0               # expansion + merge operations
    # wavefront rounds / burst pivot steps; None for the sequential
    # reduction, which has no rounds
    rounds: Optional[int] = 0


@functools.lru_cache(maxsize=None)
def _face_table() -> tuple:
    """FACES[2] as nested tuples: (face type, dx, dy, dz) per face."""
    return tuple(tuple(tuple(int(v) for v in e) for e in row)
                 for row in FACES[2])


def _tri_boundary(grid: Grid, tri: int) -> Set[int]:
    """The three edge sids of triangle ``tri`` (host integers), as the
    reference's ``_tri_boundary`` gives them."""
    nx, ny, _ = grid.dims
    base, t = divmod(int(tri), NTYPES[2])
    x = base % nx
    y = (base // nx) % ny
    z = base // (nx * ny)
    return {((x + dx) + nx * ((y + dy) + ny * (z + dz))) * NTYPES[1] + ft
            for ft, dx, dy, dz in _face_table()[t]}


def pair_saddle_saddle_seq(grid: Grid, gf: GradientField, ci: CriticalInfo,
                           c1: torch.Tensor,
                           c2: torch.Tensor) -> SaddleSaddlePairs:
    """D1 by sequential homologous propagation; ``c1`` are the unpaired
    critical edges, ``c2`` the unpaired critical triangles.  Raises
    :class:`~repro_torch.kernels.sandwich.GradientInvariantError` when the
    propagation reaches a negative edge."""
    from repro_torch.kernels.sandwich import _invariant_error
    dev = c2.device
    erank = ci.ranks[1].cpu().numpy()
    trank = ci.ranks[2].cpu().numpy()
    pair_up1 = gf.pair_up[1].cpu().numpy()
    c1_set = set(c1.tolist())
    c2 = c2.cpu().numpy().astype(np.int64)
    order_c2 = c2[np.argsort(trank[c2])]
    pair_of_edge: Dict[int, int] = {}
    boundary: Dict[int, Set[int]] = {}
    pairs: List[Tuple[int, int]] = []
    unpaired_tri: List[int] = []
    expansions = 0

    for s in order_c2.tolist():
        B = _tri_boundary(grid, s)
        while B:
            tau = max(B, key=lambda e: erank[e])
            up = int(pair_up1[tau])
            if up >= 0:
                # non-critical positive edge: expand with its 2-chain step
                B ^= _tri_boundary(grid, up)
                expansions += 1
            elif tau in pair_of_edge:
                s2 = pair_of_edge[tau]
                if trank[s2] >= trank[s]:
                    raise AssertionError("ascending order violated")
                B ^= boundary[s2]
                expansions += 1
            else:
                if tau not in c1_set:
                    raise _invariant_error(tau)
                pair_of_edge[tau] = s
                boundary[s] = B
                pairs.append((tau, s))
                break
        else:
            unpaired_tri.append(s)  # boundary vanished: essential 2-class

    def conv(a) -> torch.Tensor:
        return torch.tensor(a, dtype=torch.int64, device=dev)
    return SaddleSaddlePairs(
        conv(pairs).reshape(-1, 2), conv(sorted(c1_set - set(pair_of_edge))),
        conv(unpaired_tri), expansions, rounds=None)
