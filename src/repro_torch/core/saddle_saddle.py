"""Saddle-saddle pairs (D1, paper Sec. II-F), as tensors.

PyTorch counterpart of ``repro.core.saddle_saddle``'s
:class:`SaddleSaddlePairs`.  The reduction itself is
:func:`repro_torch.kernels.sandwich.pair_saddle_saddle_wavefront`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class SaddleSaddlePairs:
    pairs: torch.Tensor               # (n, 2) (edge sid birth, triangle death)
    unpaired_edges: torch.Tensor      # essential H1 generators, ascending
    unpaired_triangles: torch.Tensor  # essential H2 feed (empty on a box)
    expansions: int = 0               # expansion + merge operations
    rounds: int = 0                   # wavefront rounds / burst pivot steps
