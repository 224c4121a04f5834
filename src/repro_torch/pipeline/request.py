"""`TopoRequest` — the declarative front door of the pipeline.

PyTorch counterpart of ``repro.pipeline.request``.  One frozen spec: the
field (numpy array or torch tensor, flat or ``(nz, ny, nx)``), the grid,
the homology dimensions, result simplification (``min_persistence`` /
``top_k``) and execution options (``backend`` / ``sandwich_backend``).

The reference's options for later parts of the port are kept as fields
so requests read the same, but :meth:`TopoRequest.resolve` raises
``NotImplementedError`` for them, naming the ROADMAP.md item that
brings them; none is ever silently ignored.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.grid import Grid

# option -> the ROADMAP.md item that ports it
_LATER = {
    "stream": "Queue 1 item 6 (streaming)",
    "chunk_z": "Queue 1 item 6 (streaming)",
    "chunk_budget": "Queue 1 item 6 (streaming)",
    "epsilon": "Queue 1 item 7 (approximation)",
    "deadline_s": "Queue 1 item 7 (approximation)",
    "progressive": "Queue 1 item 7 (approximation)",
    "cache": "Queue 1 item 8 (host-side services: cache/)",
    "trace": "Queue 1 item 8 (host-side services: obs/)",
    "n_blocks": "Queue 1 item 9 (distributed engines)",
    "distributed": "Queue 1 item 9 (distributed engines)",
}


def _shape(field) -> tuple:
    if isinstance(field, torch.Tensor):
        return tuple(field.shape)
    return np.shape(field)


def resolve_grid(field, grid: Optional[Grid] = None) -> Grid:
    """An explicit ``grid`` wins; a shaped field infers ``dims =
    shape[::-1]`` (index order is ``[z, y, x]``); a flat field cannot be
    inferred."""
    if grid is not None:
        return grid
    shape = _shape(field)
    if len(shape) > 1:
        return Grid.of(*shape[::-1])
    raise ValueError(
        "cannot infer the grid from a flat field; pass grid= or a "
        "field shaped (nz, ny, nx)")


@dataclass(frozen=True, eq=False)
class TopoRequest:
    """Declarative persistence-diagram request (frozen spec).

    field : numpy array or torch tensor, flat or ``(nz, ny, nx)``.
    grid : explicit :class:`Grid`; inferred by :meth:`resolve` if None.
    homology_dims : homology dimensions to compute (None = all); back-end
        stages whose outputs are not requested are dropped.
    min_persistence, top_k : default simplification applied by
        :meth:`DiagramResult.pairs` when the caller passes no override.
    backend, sandwich_backend : ``None`` inherits the pipeline default.
    include_report : attach the :class:`StageReport` to the result.
    The remaining fields belong to later parts of the port (see
    ``_LATER``) and must stay unset.
    """

    field: Any
    grid: Optional[Grid] = None
    homology_dims: Optional[Tuple[int, ...]] = None
    min_persistence: Optional[float] = None
    top_k: Optional[int] = None
    backend: Optional[str] = None
    sandwich_backend: Optional[str] = None
    n_blocks: Optional[int] = None
    distributed: Optional[bool] = None
    stream: Optional[bool] = None
    chunk_z: Optional[int] = None
    chunk_budget: Optional[int] = None
    epsilon: Optional[float] = None
    deadline_s: Optional[float] = None
    progressive: bool = False
    cache: Optional[bool] = None
    trace: bool = False
    include_report: bool = True

    def __post_init__(self):
        if self.field is None:
            raise TypeError("TopoRequest needs a field; got None")
        if self.min_persistence is not None and self.min_persistence < 0:
            raise ValueError(
                f"min_persistence must be >= 0, got {self.min_persistence}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.homology_dims is not None:
            dims = tuple(int(d) for d in self.homology_dims)
            if not dims:
                raise ValueError("homology_dims must not be empty")
            if any(d < 0 or d > 3 for d in dims):
                raise ValueError(
                    f"homology_dims must lie in [0, 3], got {dims}")
            object.__setattr__(self, "homology_dims", tuple(sorted(set(dims))))

    def _later_options(self):
        """Names of set options that a later part of the port brings."""
        unset = {"n_blocks": (None, 1), "distributed": (None, False),
                 "progressive": (False,), "trace": (False,),
                 "stream": (None, False)}
        return [k for k in _LATER
                if getattr(self, k) not in unset.get(k, (None,))]

    def resolve(self) -> "TopoRequest":
        """Validation + grid inference; returns a new frozen request with
        ``grid`` filled in."""
        later = self._later_options()
        if later:
            raise NotImplementedError(
                f"{later[0]}= is not ported to repro_torch yet; see "
                f"ROADMAP.md {_LATER[later[0]]}")
        if not isinstance(self.field, (np.ndarray, torch.Tensor)):
            raise NotImplementedError(
                "repro_torch takes in-memory fields (numpy arrays or torch "
                f"tensors); field sources come with ROADMAP.md "
                f"{_LATER['stream']}")
        shape = _shape(self.field)
        if self.grid is not None:
            if len(shape) > 1 and Grid.of(*shape[::-1]).dims != self.grid.dims:
                raise ValueError(
                    f"grid dims {self.grid.dims} conflict with the field "
                    f"shape {shape}; reshape the field or fix grid=")
            if len(shape) == 1 and shape[0] != self.grid.nv:
                raise ValueError(
                    f"flat field has {shape[0]} values but grid "
                    f"{self.grid.dims} has {self.grid.nv} vertices")
        grid = resolve_grid(self.field, self.grid)
        if self.homology_dims is not None:
            bad = [d for d in self.homology_dims if d > grid.dim]
            if bad:
                raise ValueError(
                    f"homology_dims {bad} exceed the grid dimension "
                    f"{grid.dim} for dims {grid.dims}")
        if grid is self.grid:
            return self
        return dataclasses.replace(self, grid=grid)

    @property
    def field_shape(self) -> tuple:
        """Batching key for the field payload."""
        return _shape(self.field)


def strip_field(req: TopoRequest) -> TopoRequest:
    """A copy of ``req`` without its field payload (``field=None``), so a
    kept result does not pin the field."""
    r = copy.copy(req)
    object.__setattr__(r, "field", None)
    return r
