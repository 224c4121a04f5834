"""Boundary-matrix reduction oracle (the algorithm behind DIPHA / PHAT).

PyTorch counterpart of ``repro.core.reduction``, on the host.  The
textbook persistence algorithm (paper Sec. II-G): build the
lexicographic filtration of the Freudenthal complex, reduce the boundary
matrix with left-to-right column additions over Z/2, read pairs off the
pivots.  It is exact, and independent of the discrete gradient, so it is
the ground truth the DMS pipelines are held against — the role DIPHA
plays for DMS in the paper's correctness checks (Sec. VI).

Only meant for small grids (tests, on-card checks at 16^3 and below):
the reduction is O(n^3) in the worst case and runs in Python.
``reduce_twist`` is the variant with the *clearing* optimization (Bauer
et al., "Clear and Compress").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .grid import Grid, vertex_order


@dataclass
class Filtration:
    """Explicit lexicographic filtration of a small grid complex."""

    grid: Grid
    order: torch.Tensor              # (nv,) vertex order, on the CPU
    sims: List[Tuple[int, int]]      # filtration position -> (dim, sid)
    pos: Dict[Tuple[int, int], int]  # (dim, sid) -> filtration position

    @property
    def n(self) -> int:
        return len(self.sims)


def build_filtration(grid: Grid, f) -> Filtration:
    """Every valid simplex sorted by its padded descending vertex-order key
    (ties between dimensions broken by dimension, then sid: faces first)."""
    f = f.cpu() if isinstance(f, torch.Tensor) \
        else torch.from_numpy(np.asarray(f))
    order = vertex_order(f)
    entries = []
    for k in range(grid.dim + 1):
        sids = grid.all_valid_sids(k)
        keys = grid.simplex_key(k, sids, order).numpy()     # (n, k+1) desc
        pad = np.full((keys.shape[0], 4 - keys.shape[1]), -1, dtype=np.int64)
        keys4 = np.concatenate([keys, pad], axis=1).tolist()
        for key, sid in zip(keys4, sids.tolist()):
            entries.append((tuple(key), k, sid))
    entries.sort()
    sims = [(k, sid) for _, k, sid in entries]
    pos = {(k, sid): i for i, (k, sid) in enumerate(sims)}
    return Filtration(grid, order, sims, pos)


def _boundary_cols(filt: Filtration) -> List[List[int]]:
    """Sorted filtration positions of each simplex's faces (empty for
    vertices), column by column in filtration order."""
    g = filt.grid
    faces: Dict[Tuple[int, int], List[int]] = {}
    for k in range(1, g.dim + 1):
        sids = g.all_valid_sids(k)
        for sid, fs in zip(sids.tolist(), g.simplex_faces(k, sids).tolist()):
            faces[(k, sid)] = fs
    return [sorted(filt.pos[(k - 1, fs)] for fs in faces[(k, sid)])
            if k else [] for k, sid in filt.sims]


def _add_mod2(a: List[int], b: List[int]) -> List[int]:
    """Symmetric difference of two sorted index lists."""
    out: List[int] = []
    i = j = 0
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            i += 1
            j += 1
        elif a[i] < b[j]:
            out.append(a[i])
            i += 1
        else:
            out.append(b[j])
            j += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return out


def reduce_standard(cols: List[List[int]]) -> Dict[int, int]:
    """Standard left-to-right reduction. Returns {birth_pos: death_pos}."""
    low_to_col: Dict[int, int] = {}
    cols = [list(c) for c in cols]
    for j in range(len(cols)):
        while cols[j]:
            low = cols[j][-1]
            if low not in low_to_col:
                low_to_col[low] = j
                break
            cols[j] = _add_mod2(cols[j], cols[low_to_col[low]])
    return {low: j for low, j in low_to_col.items()}


def reduce_twist(cols: List[List[int]], dims: List[int],
                 maxdim: int) -> Dict[int, int]:
    """Reduction with the *clearing* optimization: process dimensions from
    high to low; once (b, d) is found, column b is cleared (it is a cycle).
    This mirrors the 'Clear and Compress' strategy DIPHA builds on."""
    low_to_col: Dict[int, int] = {}
    cols = [list(c) for c in cols]
    cleared = set()
    for k in range(maxdim, 0, -1):
        for j in range(len(cols)):
            if dims[j] != k or j in cleared:
                continue
            while cols[j]:
                low = cols[j][-1]
                if low not in low_to_col:
                    low_to_col[low] = j
                    cleared.add(low)
                    cols[low] = []
                    break
                cols[j] = _add_mod2(cols[j], cols[low_to_col[low]])
    return {low: j for low, j in low_to_col.items()}


@dataclass
class DiagramOracle:
    """Canonical persistence pairing of the lexicographic filtration."""

    # per-dimension (birth_sid, death_sid) list; death is a (dim+1)-simplex
    pairs: Dict[int, List[Tuple[int, int]]]
    # per-dimension list of essential birth sids (infinite persistence)
    essential: Dict[int, List[int]]
    filt: Filtration

    def betti(self) -> Dict[int, int]:
        return {k: len(v) for k, v in self.essential.items()}


def compute_oracle(grid: Grid, f, twist: bool = True) -> DiagramOracle:
    """The exact persistence pairing of field ``f`` (numpy array or tensor)
    by boundary-matrix reduction, on the host."""
    filt = build_filtration(grid, f)
    cols = _boundary_cols(filt)
    dims = [k for k, _ in filt.sims]
    red = (reduce_twist(cols, dims, grid.dim) if twist
           else reduce_standard(cols))
    paired = set()
    pairs: Dict[int, List[Tuple[int, int]]] = {
        k: [] for k in range(grid.dim + 1)}
    for b, d in red.items():
        kb, sb = filt.sims[b]
        kd, sd = filt.sims[d]
        if kd != kb + 1:
            raise AssertionError(f"pair of dims {kb} and {kd}")
        pairs[kb].append((sb, sd))
        paired.add(b)
        paired.add(d)
    essential: Dict[int, List[int]] = {k: [] for k in range(grid.dim + 1)}
    for i, (k, sid) in enumerate(filt.sims):
        if i not in paired:
            essential[k].append(sid)
    return DiagramOracle(pairs, essential, filt)
