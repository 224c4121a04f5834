"""Extremum-saddle pairs (paper Alg. 1), as tensors.

PyTorch counterpart of ``repro.core.pairing``'s :class:`ExtremaPairs`.
The pairing itself is
:func:`repro_torch.kernels.sandwich.pair_extrema_saddles_kernel`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch


@dataclass
class ExtremaPairs:
    saddles: torch.Tensor    # (n,) saddle sid of each pair
    extrema: torch.Tensor    # (n,) the extremum that dies at that saddle
    unpaired: torch.Tensor   # extremum sids never paired (OMEGA excluded)

    @property
    def pairs(self) -> List[Tuple[int, int]]:
        """(saddle, extremum) tuples, as the reference lists them."""
        return list(zip(self.saddles.tolist(), self.extrema.tolist()))
