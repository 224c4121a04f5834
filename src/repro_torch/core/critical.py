"""Critical simplices + per-dimension ranks (paper Sec. III, 'Extract & sort').

PyTorch counterpart of ``repro.core.critical``.  :func:`extract_critical`
is the reference's dense extraction: :func:`simplex_ranks` gives every
valid k-simplex its position in the global lexicographic order of
dimension k (numpy's ``lexsort`` on a host copy of the descending
vertex-order keys), and the critical simplices are sorted by it.  The
kernel back-end builds the same :class:`CriticalInfo` with
:func:`repro_torch.kernels.sandwich.extract_critical_kernel`; every later
stage only *compares* ranks, so any order-isomorphic injective key works,
and an entry no stage reads need never be built (:class:`DeferredRanks`).
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from .gradient import GradientField
from .grid import Grid


def simplex_ranks(grid: Grid, k: int, order: torch.Tensor) -> np.ndarray:
    """Dense (sid_space,) int64 host array: rank of each valid k-simplex in
    the global lexicographic order of dimension k; -1 for invalid sids."""
    order = order.cpu()
    vs = grid.all_valid_sids(k)
    keys = grid.simplex_key(k, vs, order).numpy()            # (n, k+1) desc
    perm = np.lexsort(tuple(keys[:, c]
                            for c in range(keys.shape[1] - 1, -1, -1)))
    ranks = np.full(grid.sid_space(k), -1, dtype=np.int64)
    ranks[vs.numpy()[perm]] = np.arange(len(vs), dtype=np.int64)
    return ranks


class DeferredRanks(Mapping):
    """A read-only ``{k: rank tensor}`` mapping whose entry ``k`` is built
    on its first read, once, by calling ``build()``.  ``in``, ``len`` and
    iteration build nothing; ``[]``, ``items()`` and ``values()`` build
    what they return."""

    def __init__(self, ready: Dict[int, torch.Tensor], k: int,
                 build: Callable[[], torch.Tensor]):
        self._ranks = dict(ready)
        self._k, self._build = k, build

    def __getitem__(self, k: int) -> torch.Tensor:
        if k == self._k and k not in self._ranks:
            self._ranks[k] = self._build()
        return self._ranks[k]

    def __contains__(self, k) -> bool:
        return k == self._k or k in self._ranks

    def __iter__(self) -> Iterator[int]:
        return iter(sorted(self._ranks.keys() | {self._k}))

    def __len__(self) -> int:
        return len(self._ranks.keys() | {self._k})


@dataclass
class CriticalInfo:
    """Sorted critical simplices + rank arrays per dimension (tensors).

    ``ranks`` holds a dense (sid_space,) rank or key array per dimension,
    as a plain dict or as :class:`DeferredRanks`: the kernel back-end
    builds dimension 1's dense edge keys on first read, so a diagram
    whose stages never read them (D0 only) never builds them."""

    grid: Grid
    order: torch.Tensor
    crit_sids: Dict[int, torch.Tensor]   # sorted by rank, ascending
    ranks: Mapping                       # k -> dense rank/key array

    def max_vertex_order(self, k: int, sids: torch.Tensor) -> torch.Tensor:
        """Order of the max vertex of each k-simplex ``sids``."""
        return self.order[self.grid.simplex_max_vertex(k, sids, self.order)]

    def to_numpy(self):
        """(order, crit_sids, ranks) as numpy arrays."""
        return (self.order.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in self.crit_sids.items()},
                {k: v.cpu().numpy() for k, v in self.ranks.items()})

    @staticmethod
    def from_numpy(grid: Grid, order, crit_sids, ranks,
                   device) -> "CriticalInfo":
        """The inverse of :meth:`to_numpy`, on ``device``."""
        def conv(a):
            return torch.as_tensor(np.asarray(a), device=device)
        return CriticalInfo(grid, conv(order),
                            {int(k): conv(v) for k, v in crit_sids.items()},
                            {int(k): conv(v) for k, v in ranks.items()})


def extract_critical(grid: Grid, gf: GradientField,
                     order: torch.Tensor) -> CriticalInfo:
    """The reference's dense extraction on a host copy: ranks of every
    valid simplex, critical sids sorted by rank; the result lives on the
    gradient's device."""
    dev = gf.crit[0].device
    crit_sids: Dict[int, torch.Tensor] = {}
    ranks: Dict[int, torch.Tensor] = {}
    for k in range(grid.dim + 1):
        rk = simplex_ranks(grid, k, order)
        cs = gf.critical_sids(k).cpu().numpy()
        crit_sids[k] = torch.from_numpy(cs[np.argsort(rk[cs])]).to(dev)
        ranks[k] = torch.from_numpy(rk).to(dev)
    return CriticalInfo(grid, order, crit_sids, ranks)
