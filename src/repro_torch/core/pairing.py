"""Extremum-saddle pairs (paper Alg. 1), as tensors.

PyTorch counterpart of ``repro.core.pairing``.  :func:`pair_extrema_saddles`
is the reference's sequential Union-Find over extremum nodes (Python
dicts on the host): triplets are processed oldest saddle first, the
younger representative dies at the saddle and the older becomes the
component representative (elder rule), with DMS's arc collapse.  The
batched pairing is
:func:`repro_torch.kernels.sandwich.pair_extrema_saddles_kernel`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from .extremum_graph import ExtremumGraph
from .tracing import OMEGA


@dataclass
class ExtremaPairs:
    saddles: torch.Tensor    # (n,) saddle sid of each pair
    extrema: torch.Tensor    # (n,) the extremum that dies at that saddle
    unpaired: torch.Tensor   # extremum sids never paired (OMEGA excluded)

    @property
    def pairs(self) -> List[Tuple[int, int]]:
        """(saddle, extremum) tuples, as the reference lists them."""
        return list(zip(self.saddles.tolist(), self.extrema.tolist()))


def pair_extrema_saddles(g: ExtremumGraph) -> ExtremaPairs:
    """The sequential elder-rule Union-Find; pairs in processing order,
    on the graph's device."""
    rep: Dict[int, int] = {}
    ext_key = g.ext_key.cpu().numpy()

    def find(t: int) -> int:
        path = []
        while rep.get(t, t) != t:
            path.append(t)
            t = rep[t]
        for p in path:
            rep[p] = t
        return t

    def key(t: int) -> Tuple[int, int]:
        # OMEGA is the oldest node: key -inf (compared as tuple)
        return (0, 0) if t == OMEGA else (1, int(ext_key[t]) + 1)

    pairs: List[Tuple[int, int]] = []
    seen: set = set()
    for s, t0, t1 in zip(g.saddles.tolist(), g.t0.tolist(), g.t1.tolist()):
        seen.add(t0)
        seen.add(t1)
        r0, r1 = find(t0), find(t1)
        if r0 == r1:
            continue
        if key(r0) < key(r1):
            r0, r1 = r1, r0
            t0, t1 = t1, t0
        if r0 == OMEGA:
            raise AssertionError("OMEGA is the oldest node and never dies")
        pairs.append((s, r0))
        rep[r0] = r1
        rep[t0] = r1  # arc collapse (path compression, paper Alg. 1 l.10)
    paired = {e for _, e in pairs}
    unpaired = sorted(t for t in seen if t != OMEGA and t not in paired)
    dev = g.saddles.device

    def conv(a) -> torch.Tensor:
        return torch.tensor(a, dtype=torch.int64, device=dev)
    return ExtremaPairs(conv([s for s, _ in pairs]),
                        conv([e for _, e in pairs]), conv(unpaired))
