"""Persistence diagram container and comparison utilities (PyTorch
counterpart of ``repro.core.diagram``).

Pairs per homology dimension as simplex ids; a pair's coordinates are
the orders (or values) of the max vertices of its birth and death
simplices.  Diagrams are compared in *order space*: zero-persistence
points (equal coordinates) sit on the diagonal and are dropped before
comparison, the invariant the paper validates (DDMS vs DMS vs DIPHA,
Sec. VI); essential classes are compared as sorted orders of their max
vertices per dimension, their counts being the Betti numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
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

    def points_order(self, p: int, drop_diagonal: bool = True
                     ) -> torch.Tensor:
        """(n, 2) points (birth order, death order) for dimension p."""
        b, d = self.pair_max_vertices(p)
        if len(b) == 0:
            return torch.zeros((0, 2), dtype=torch.int64,
                               device=self.order.device)
        pts = torch.stack([self.order[b], self.order[d]], dim=1)
        if drop_diagonal:
            pts = pts[pts[:, 0] != pts[:, 1]]
        return pts

    def points_value(self, p: int, f) -> torch.Tensor:
        """(n, 2) points (birth f-value, death f-value) for dimension p
        (f(sigma) = highest vertex value, paper Sec. II-E)."""
        fr = (f if isinstance(f, torch.Tensor)
              else torch.from_numpy(np.asarray(f))).reshape(-1)
        b, d = self.pair_max_vertices(p)
        if len(b) == 0:
            return torch.zeros((0, 2), dtype=fr.dtype, device=fr.device)
        return torch.stack([fr[b.to(fr.device)], fr[d.to(fr.device)]], dim=1)

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

    def essential_orders(self, p: int) -> torch.Tensor:
        """Sorted orders of the max vertices of the essential dim-p
        classes."""
        v = self.essential_max_vertices(p)
        if len(v) == 0:
            return self._empty()
        return torch.sort(self.order[v]).values

    def betti(self) -> Dict[int, int]:
        return {p: len(self.essential.get(p, ()))
                for p in range(self.grid.dim + 1)}


def _sorted_rows(a: torch.Tensor) -> torch.Tensor:
    """Rows of an (n, 2) tensor in lexicographic order, on the CPU."""
    a = a.cpu().reshape(-1, 2)
    a = a[torch.argsort(a[:, 1], stable=True)]
    return a[torch.argsort(a[:, 0], stable=True)]


def same_offdiagonal(d1: Diagram, d2: Diagram, dims=None) -> bool:
    """Whether the off-diagonal order-space points of two diagrams are the
    same multisets in every dimension of ``dims`` (all pair dimensions if
    None); the diagrams may live on different devices."""
    dims = dims if dims is not None else range(d1.grid.dim)
    return all(torch.equal(_sorted_rows(d1.points_order(p)),
                           _sorted_rows(d2.points_order(p))) for p in dims)


def diff_report(d1: Diagram, d2: Diagram, names=("A", "B")) -> str:
    """Readable differences of two diagrams (off-diagonal points and
    essential orders), or ``"diagrams equal"``."""
    out = []
    for p in range(d1.grid.dim):
        sa = {tuple(r) for r in _sorted_rows(d1.points_order(p)).tolist()}
        sb = {tuple(r) for r in _sorted_rows(d2.points_order(p)).tolist()}
        if sa != sb:
            out.append(f"D{p}: only {names[0]}: {sorted(sa - sb)}; "
                       f"only {names[1]}: {sorted(sb - sa)}")
    for p in range(d1.grid.dim + 1):
        ea = d1.essential_orders(p).tolist()
        eb = d2.essential_orders(p).tolist()
        if ea != eb:
            out.append(f"essential[{p}]: {names[0]}={ea} {names[1]}={eb}")
    return "\n".join(out) if out else "diagrams equal"
