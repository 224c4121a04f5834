"""`TopoRequest` — the declarative front door of the pipeline.

PyTorch counterpart of ``repro.pipeline.request``.  One frozen spec: the
field (numpy array or torch tensor, flat or ``(nz, ny, nx)``, or an
out-of-core :class:`~repro_torch.stream.FieldSource`), the grid, the
homology dimensions, result simplification (``min_persistence`` /
``top_k``), execution options (``backend`` / ``sandwich_backend`` /
streaming chunking / ``n_blocks`` for the sharded streaming engine), the
approximation knobs (``epsilon`` / ``deadline_s`` / ``progressive``,
answered by :mod:`repro_torch.approx`), the diagram-cache participation
(``cache``) and per-run tracing (``trace``).

The distributed engines are not ported yet: ``distributed=True`` and an
in-memory ``n_blocks > 1`` make :meth:`TopoRequest.resolve` raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
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
    "distributed": "Queue 1 item 9 (distributed engines)",
    "n_blocks": "Queue 1 item 9 (distributed engines)",
}


def _is_source(field) -> bool:
    """True for FieldSource-shaped objects that are not plain arrays."""
    if isinstance(field, (np.ndarray, torch.Tensor)):
        return False
    return hasattr(field, "read_slab") and hasattr(field, "dims")


def _shape(field) -> tuple:
    if _is_source(field):
        return ("stream",) + tuple(field.dims)
    if isinstance(field, torch.Tensor):
        return tuple(field.shape)
    return np.shape(field)


def resolve_grid(field, grid: Optional[Grid] = None) -> Grid:
    """An explicit ``grid`` wins; a :class:`FieldSource` carries its own
    ``dims``; a shaped field infers ``dims = shape[::-1]`` (index order is
    ``[z, y, x]``); a flat field cannot be inferred."""
    if grid is not None:
        return grid
    if _is_source(field):
        return Grid.of(*field.dims)
    shape = _shape(field)
    if len(shape) > 1:
        return Grid.of(*shape[::-1])
    raise ValueError(
        "cannot infer the grid from a flat field; pass grid= or a "
        "field shaped (nz, ny, nx)")


@dataclass(frozen=True, eq=False)
class TopoRequest:
    """Declarative persistence-diagram request (frozen spec).

    field : numpy array or torch tensor, flat or ``(nz, ny, nx)``, or a
        ``FieldSource`` (out-of-core; implies the streamed path).
    grid : explicit :class:`Grid`; inferred by :meth:`resolve` if None.
    homology_dims : homology dimensions to compute (None = all); back-end
        stages whose outputs are not requested are dropped.
    min_persistence, top_k : default simplification applied by
        :meth:`DiagramResult.pairs` when the caller passes no override.
    backend, sandwich_backend : ``None`` inherits the pipeline default.
    stream : force (True) / forbid (False) the out-of-core path; ``None``
        streams iff the field is a source or a chunk knob is set.
    chunk_z, chunk_budget : streamed decomposition knobs (at most one);
        in a sharded streamed run they apply per shard.
    n_blocks : z-slab shards of the sharded streaming engine; ``> 1`` is
        taken only by a streamed request with ``distributed=False`` (the
        reference reads ``n_blocks > 1`` with ``distributed`` unset as a
        request for the distributed engines, which come later).
    epsilon : guaranteed bottleneck-error budget (field units, >= 0),
        answered from the coarsest hierarchy level whose bound meets it.
    deadline_s : wall-clock budget of progressive refinement (the
        coarsest preview always completes); implies the progressive path.
    progressive : refine coarse to fine through every hierarchy level;
        ``run`` returns the final (tightest) result.
    cache : diagram-cache participation through a cache-enabled
        ``TopoService``: None participates, False opts out, True requires
        a cache key (:class:`~repro_torch.cache.CacheKeyError` otherwise).
    trace : record a span timeline of this run (``result.trace``).
    include_report : attach the :class:`StageReport` to the result.
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
            raise TypeError("TopoRequest needs a field (array, tensor or "
                            "FieldSource); got None")
        if self.min_persistence is not None and self.min_persistence < 0:
            raise ValueError(
                f"min_persistence must be >= 0, got {self.min_persistence}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.n_blocks is not None and self.n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {self.n_blocks}")
        if self.chunk_z is not None and self.chunk_budget is not None:
            raise ValueError(
                "pass at most one of chunk_z= / chunk_budget=")
        if self.chunk_z is not None and self.chunk_z < 1:
            raise ValueError(f"chunk_z must be >= 1, got {self.chunk_z}")
        if self.chunk_budget is not None and self.chunk_budget < 1:
            raise ValueError(
                f"chunk_budget must be >= 1 byte, got {self.chunk_budget}")
        if self.epsilon is not None and not self.epsilon >= 0:
            raise ValueError(
                f"epsilon must be >= 0 (field units), got {self.epsilon}")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")
        if self.homology_dims is not None:
            dims = tuple(int(d) for d in self.homology_dims)
            if not dims:
                raise ValueError("homology_dims must not be empty")
            if any(d < 0 or d > 3 for d in dims):
                raise ValueError(
                    f"homology_dims must lie in [0, 3], got {dims}")
            object.__setattr__(self, "homology_dims", tuple(sorted(set(dims))))

    @property
    def is_stream(self) -> bool:
        """Whether this request takes the out-of-core path."""
        if self.stream is not None:
            return bool(self.stream)
        return _is_source(self.field) or self.chunk_z is not None \
            or self.chunk_budget is not None

    @property
    def is_approx(self) -> bool:
        """Whether this request routes through ``repro_torch.approx``."""
        return self.epsilon is not None or self.progressive \
            or self.deadline_s is not None

    def _later_options(self):
        """Names of set options that a later part of the port brings."""
        later = ["distributed"] if self.distributed else []
        # n_blocks > 1 is the sharded streaming engine when streamed with
        # distributed=False, else a request for the distributed engines
        if (self.n_blocks or 1) > 1 and (self.distributed is None
                                         or not self.is_stream):
            later.append("n_blocks")
        return later

    def resolve(self) -> "TopoRequest":
        """Validation + grid inference; returns a new frozen request with
        ``grid`` filled in."""
        later = self._later_options()
        if later:
            extra = ("; n_blocks > 1 runs here only as a streamed request "
                     "with distributed=False (the sharded streaming engine)"
                     if later[0] == "n_blocks" else "")
            raise NotImplementedError(
                f"{later[0]}= is not ported to repro_torch yet; see "
                f"ROADMAP.md {_LATER[later[0]]}{extra}")
        if self.stream is False and _is_source(self.field):
            raise ValueError(
                "stream=False conflicts with a FieldSource field; sources "
                "are only served by the streamed path")
        if not self.is_stream and (self.chunk_z is not None
                                   or self.chunk_budget is not None):
            raise ValueError(
                "chunk_z/chunk_budget only apply to streamed requests")
        if not _is_source(self.field) \
                and not isinstance(self.field, (np.ndarray, torch.Tensor)):
            raise TypeError(
                "repro_torch takes numpy arrays, torch tensors or "
                f"FieldSources as fields, got {type(self.field).__name__}")
        shape = _shape(self.field)
        if self.grid is not None:
            if _is_source(self.field):
                src_dims = Grid.of(*self.field.dims).dims
                if tuple(self.grid.dims) != src_dims:
                    raise ValueError(
                        f"grid dims {self.grid.dims} conflict with the "
                        f"FieldSource's own dims {src_dims}; a source is "
                        f"authoritative — omit grid= or make them match")
            elif len(shape) > 1 \
                    and Grid.of(*shape[::-1]).dims != self.grid.dims:
                raise ValueError(
                    f"grid dims {self.grid.dims} conflict with the field "
                    f"shape {shape}; reshape the field or fix grid=")
            elif len(shape) == 1 and shape[0] != self.grid.nv:
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

    def replace(self, **kw) -> "TopoRequest":
        """``dataclasses.replace`` convenience (requests are frozen)."""
        return dataclasses.replace(self, **kw)

    def cache_key(self) -> tuple:
        """The canonical content-addressed cache key of this request
        (:func:`repro_torch.cache.request_key`); raises
        :class:`~repro_torch.cache.CacheKeyError` when the field cannot be
        fingerprinted."""
        from repro_torch.cache.fingerprint import request_key
        return request_key(self)

    @property
    def field_shape(self) -> tuple:
        """Batching key for the field payload (source dims or shape)."""
        return _shape(self.field)


def strip_field(req: TopoRequest) -> TopoRequest:
    """A copy of ``req`` without its field payload (``field=None``), so a
    kept result does not pin the field."""
    r = copy.copy(req)
    object.__setattr__(r, "field", None)
    return r
