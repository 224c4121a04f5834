"""Saddle-saddle pairs (D1, paper Sec. II-F), as tensors.

PyTorch counterpart of ``repro.core.saddle_saddle``'s
:class:`SaddleSaddlePairs` and ``_tri_boundary``.  The reductions are
:func:`repro_torch.kernels.sandwich.pair_saddle_saddle_wavefront` and the
distributed token engine :func:`repro_torch.distributed.d1_rounds
.d1_distributed`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Set

import torch

from .grid import FACES, NTYPES, Grid


@dataclass
class SaddleSaddlePairs:
    pairs: torch.Tensor               # (n, 2) (edge sid birth, triangle death)
    unpaired_edges: torch.Tensor      # essential H1 generators, ascending
    unpaired_triangles: torch.Tensor  # essential H2 feed (empty on a box)
    expansions: int = 0               # expansion + merge operations
    rounds: int = 0                   # wavefront rounds / burst pivot steps


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
