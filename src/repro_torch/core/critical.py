"""Critical simplices + per-dimension ranks (paper Sec. III, 'Extract & sort').

PyTorch counterpart of ``repro.core.critical``'s :class:`CriticalInfo`.
The kernel back-end builds it with
:func:`repro_torch.kernels.sandwich.extract_critical_kernel`; every later
stage only *compares* ranks, so any order-isomorphic injective key works.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .grid import Grid


@dataclass
class CriticalInfo:
    """Sorted critical simplices + rank arrays per dimension (tensors)."""

    grid: Grid
    order: torch.Tensor
    crit_sids: Dict[int, torch.Tensor]   # sorted by rank, ascending
    ranks: Dict[int, torch.Tensor]       # dense rank/key arrays

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
