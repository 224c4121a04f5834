"""Persistence diagram container (PyTorch counterpart of
``repro.core.diagram``).

Pairs per homology dimension as simplex ids; a pair's coordinates are
the orders (or values) of the max vertices of its birth and death
simplices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from .grid import Grid


@dataclass
class Diagram:
    """Persistence pairs per homology dimension, as simplex-id tensors."""

    grid: Grid
    order: torch.Tensor
    # pairs[p] = (n, 2): (birth sid of dim p, death sid of dim p+1)
    pairs: Dict[int, torch.Tensor] = field(default_factory=dict)
    # essential[p] = (n,) birth sids (infinite persistence)
    essential: Dict[int, torch.Tensor] = field(default_factory=dict)

    def _empty(self) -> torch.Tensor:
        return torch.zeros(0, dtype=torch.int64, device=self.order.device)

    def pair_max_vertices(self, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(birth vertices, death vertices) of the dim-p pairs — the
        filtration-defining max vertex of each simplex (Sec. II-E)."""
        pr = self.pairs.get(p)
        if pr is None or len(pr) == 0:
            return self._empty(), self._empty()
        return (self.grid.simplex_max_vertex(p, pr[:, 0], self.order),
                self.grid.simplex_max_vertex(p + 1, pr[:, 1], self.order))

    def essential_max_vertices(self, p: int) -> torch.Tensor:
        """Max vertices of the essential dim-p classes (unsorted)."""
        es = self.essential.get(p)
        if es is None or len(es) == 0:
            return self._empty()
        return self.grid.simplex_max_vertex(p, es, self.order)
