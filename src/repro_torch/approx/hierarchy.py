"""Power-of-two multiresolution hierarchy with provable error bounds.

PyTorch counterpart of ``repro.approx.hierarchy`` (after Vidal & Tierny,
"Fast Approximation of Persistence Diagrams with Guarantees"):

- **Decimation.**  Level ``l`` keeps the fine vertices whose index is a
  multiple of ``2^l`` on every axis.  The subsets nest, and the coarse
  grid (``ceil(n / 2^l)`` per axis) is a regular grid the pipeline runs
  unchanged.
- **Error field.**  Each coarse vertex owns the fine block ``[c*s,
  (c+1)*s)`` per axis (clipped); the block's f-diameter (max - min, in
  float64 over the exact float32 extremes) bounds ``|f - f_l|`` there,
  and its maximum bounds the bottleneck error of the level's diagram.
  Blocks nest, so bounds never grow under refinement.
- **Pyramid.**  One stride-2 min/max pass over the fine field on the
  pipeline's device (:func:`block_minmax`: edge-pad, reshape to
  ``(nz/s, s, ny/s, s, nx/s, s)``, ``amin`` / ``amax`` over the block
  axes), then stride-2 cascades coarse to coarser.  Out-of-core sources
  stream z-slabs of ~8 MB through the same pass, each read once and
  copied to the device, keeping only the level-1 planes.

In-memory fields decimate to contiguous ``(ncz, ncy, ncx)`` tensors on the
device; sources to :class:`~repro_torch.stream.DecimatedSource`, so coarse
levels stream through the unchanged chunk scheduler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.grid import Grid
from repro_torch.pipeline.request import _is_source, resolve_grid
from repro_torch.stream.chunks import DecimatedSource, as_source

MAX_LEVELS = 10   # stride 2^10 = 1024: beyond any grid this repo runs


def coarse_dims(dims, stride: int) -> Tuple[int, int, int]:
    """Vertex dims of the stride-decimated grid (``ceil(n / stride)``)."""
    return tuple((int(d) + stride - 1) // stride for d in Grid.of(*dims).dims)


def as_tensor(field, device=None) -> torch.Tensor:
    """A field (numpy array or tensor) as a tensor on ``device`` (its own
    device if None), with its dtype; no copy when it is already there."""
    if not isinstance(field, torch.Tensor):
        field = torch.from_numpy(np.ascontiguousarray(field))
    return field if device is None else field.to(device)


def _pad_block(vol: torch.Tensor, s: int) -> torch.Tensor:
    """Edge-pad each axis to a multiple of ``s``, as ``np.pad(mode=
    "edge")`` does (a replicated value stays inside its own clipped block,
    so block extremes do not change); axes of size 1 and strides longer
    than an axis included."""
    for axis in range(3):
        n = vol.shape[axis]
        pad = (-n) % s
        if pad:
            last = vol.narrow(axis, n - 1, 1)
            shape = list(vol.shape)
            shape[axis] = pad
            vol = torch.cat([vol, last.expand(shape)], dim=axis)
    return vol


def _blocks(vol: torch.Tensor, s: int) -> torch.Tensor:
    """The ``(nz/s, s, ny/s, s, nx/s, s)`` block view of a padded volume."""
    v = _pad_block(vol, s)
    nz, ny, nx = v.shape
    return v.reshape(nz // s, s, ny // s, s, nx // s, s)


def block_minmax(vol, s: int, device=None):
    """Per-block (stride ``s``, clipped at the boundary) min and max of a
    ``(nz, ny, nx)`` volume, as two tensors of the coarse dims on
    ``device`` (the volume's own if None)."""
    if s < 1:
        raise ValueError(f"stride must be >= 1, got {s}")
    v = as_tensor(vol, device)
    if s == 1:
        return v.clone(), v.clone()
    r = _blocks(v, s)
    return r.amin(dim=(1, 3, 5)), r.amax(dim=(1, 3, 5))


def cascade_minmax(mn: torch.Tensor, mx: torch.Tensor, top: int):
    """The min/max pyramid of levels 1..``top`` from the level-1 pair, as
    ``({l: min}, {l: max})``.  Level-l blocks are unions of level-(l-1)
    blocks, so each stride-2 step is exact (no re-read of the fine
    field)."""
    mins, maxs = {1: mn}, {1: mx}
    for l in range(2, top + 1):
        mins[l] = _blocks(mins[l - 1], 2).amin(dim=(1, 3, 5))
        maxs[l] = _blocks(maxs[l - 1], 2).amax(dim=(1, 3, 5))
    return mins, maxs


def level_bound(mn: torch.Tensor, mx: torch.Tensor) -> float:
    """Largest block f-diameter, in float64 over exact extremes."""
    return float((mx.double() - mn.double()).max())


@dataclass(frozen=True)
class Level:
    """One hierarchy level: stride, coarse grid dims, guaranteed bound.

    ``bound`` is an upper bound (field units, float64) on the bottleneck
    distance between the level's diagram and the exact diagram; level 0
    is the fine grid itself (``bound == 0.0``)."""

    level: int
    stride: int
    dims: Tuple[int, int, int]    # coarse vertex dims (nx, ny, nz)
    bound: float

    @property
    def n_vertices(self) -> int:
        return int(np.prod(self.dims))


class Hierarchy:
    """Multiresolution decimation of one field with per-level bounds.

    field : numpy array or tensor (flat or ``(nz, ny, nx)``), or a
        ``FieldSource``.
    grid : explicit :class:`Grid` (inferred if None; flat fields need it).
    device : where the pyramid is computed and in-memory levels live
        (the pipeline's device); None keeps a tensor's own device and
        puts numpy fields on the CPU.
    max_level : cap on the coarsest level (default: as coarse as the grid
        allows with every axis keeping >= 2 vertices, so the complex
        dimension is the same at every level).
    """

    def __init__(self, field, grid: Optional[Grid] = None, *, device=None,
                 max_level: Optional[int] = None):
        self.grid = resolve_grid(field, grid)
        nx, ny, nz = self.grid.dims
        if _is_source(field):
            self._source = as_source(field, dims=self.grid.dims)
            self._f3 = None
            self.device = torch.device("cpu" if device is None else device)
        else:
            self._source = None
            self._f3 = as_tensor(field, device).reshape(nz, ny, nx)
            self.device = self._f3.device
        cap = MAX_LEVELS if max_level is None else int(max_level)
        top = 0
        while top < cap and all(
                d == 1 or d > 2 ** (top + 1) for d in self.grid.dims):
            top += 1
        self._mins: Dict[int, torch.Tensor] = {}
        self._maxs: Dict[int, torch.Tensor] = {}
        if top >= 1:
            self._mins, self._maxs = cascade_minmax(*self._level1_minmax(),
                                                    top)
        self.levels: List[Level] = [Level(0, 1, self.grid.dims, 0.0)] + [
            Level(l, 2 ** l, coarse_dims(self.grid.dims, 2 ** l),
                  level_bound(self._mins[l], self._maxs[l]))
            for l in range(1, top + 1)]

    # -- pyramid -------------------------------------------------------------

    def _level1_minmax(self):
        if self._f3 is not None:
            return block_minmax(self._f3, 2)
        # out-of-core: an even plane count per slab keeps z-blocks whole
        # (~8 MB of float32 planes per read); only the level-1 planes stay
        src = self._source
        nx, ny, nz = self.grid.dims
        group = 2 * max(1, (8 << 20) // max(1, nx * ny * 4) // 2)
        mns, mxs = [], []
        for zlo in range(0, nz, group):
            slab = torch.from_numpy(src.read_slab(zlo, min(zlo + group, nz)))
            mn, mx = block_minmax(slab, 2, self.device)
            mns.append(mn)
            mxs.append(mx)
        return torch.cat(mns, dim=0), torch.cat(mxs, dim=0)

    # -- views ---------------------------------------------------------------

    @property
    def max_level(self) -> int:
        return self.levels[-1].level

    def level(self, l: int) -> Level:
        if not (0 <= l <= self.max_level):
            raise ValueError(
                f"level {l} out of range: this hierarchy offers 0.."
                f"{self.max_level} for dims {self.grid.dims}")
        return self.levels[l]

    def bound(self, l: int) -> float:
        """Guaranteed bottleneck-error bound of level ``l`` (f units)."""
        return self.level(l).bound

    def error_field(self, l: int) -> torch.Tensor:
        """Per-coarse-vertex error field of level ``l``: the f-diameter of
        each vertex's fine block, ``(ncz, ncy, ncx)`` float64."""
        if l == 0:
            nx, ny, nz = self.grid.dims
            return torch.zeros((nz, ny, nx), dtype=torch.float64,
                               device=self.device)
        if l not in self._mins:
            raise ValueError(
                f"level {l} out of range: this hierarchy offers 0.."
                f"{max(self._mins, default=0)} for dims {self.grid.dims}")
        return self._maxs[l].double() - self._mins[l].double()

    def decimate(self, l: int):
        """The level-``l`` field for a :class:`TopoRequest`: a contiguous
        ``(ncz, ncy, ncx)`` tensor for in-memory fields, a
        :class:`DecimatedSource` for out-of-core sources."""
        lev = self.level(l)
        if self._source is not None:
            if lev.stride == 1:
                return self._source
            return DecimatedSource(self._source, lev.stride)
        s = lev.stride
        return self._f3[::s, ::s, ::s].contiguous()

    def pick_level(self, epsilon: float) -> Level:
        """The coarsest level whose guaranteed bound meets ``epsilon``
        (level 0 always qualifies: its bound is 0)."""
        if epsilon < 0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        for lev in reversed(self.levels):
            if lev.bound <= epsilon:
                return lev
        return self.levels[0]
