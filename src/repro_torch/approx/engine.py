"""`approximate` — bounded-error diagrams from the multiresolution hierarchy.

PyTorch counterpart of ``repro.approx.engine``.
``approximate(pipeline, request, epsilon=...)`` picks the coarsest
hierarchy level whose guaranteed bound meets ``epsilon`` (or runs an
explicit ``level=``), runs the standard pipeline on the decimated field
on the pipeline's device, and returns a :class:`DiagramResult` carrying
its guarantee: ``error_bound``, ``approx_level``, ``approx_stride``,
``uncertainty_threshold`` and ``pairs(certain_only=True)``, stored in the
optional ``approx_meta`` wire array (byte for byte the reference's).

An in-memory field goes to the device once: the level-1 probe, the
hierarchy and every level's run share that tensor, and a call given a
``hierarchy=`` reuses the hierarchy's copy.  ``level=0``,
``epsilon=0``, and an ``epsilon`` that even level 1 misses run the exact
pipeline without building the pyramid.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.pipeline.request import TopoRequest, _is_source, strip_field

from .hierarchy import Hierarchy, Level, as_tensor, block_minmax, level_bound

APPROX_META = "approx_meta"   # [bound, level, stride, fine nx, ny, nz]


def _as_resolved(pipeline, request,
                 hierarchy: Optional[Hierarchy] = None) -> TopoRequest:
    """The resolved request, its in-memory field moved to the pipeline's
    device once (every later step reuses that tensor).  With a
    ``hierarchy`` of an in-memory field, its device copy is reused."""
    if not isinstance(request, TopoRequest):
        request = TopoRequest(field=request)
    req = request.resolve()
    if _is_source(req.field):
        return req
    if hierarchy is not None and hierarchy._f3 is not None:
        return req.replace(field=hierarchy._f3.reshape(
            tuple(req.field.shape)))
    return req.replace(field=as_tensor(req.field, pipeline.device))


def _base_request(req: TopoRequest) -> TopoRequest:
    """The request without the approximation knobs: what runs (at some
    level) through the standard resolver."""
    return req.replace(epsilon=None, deadline_s=None, progressive=False)


def build_hierarchy(pipeline, req: TopoRequest) -> Hierarchy:
    """The hierarchy of a resolved request, on the pipeline's device."""
    return Hierarchy(req.field, req.grid, device=pipeline.device)


def _level_request(base: TopoRequest, hierarchy: Hierarchy,
                   lev: Level) -> TopoRequest:
    """The decimated sub-request of one level (grid re-inferred from the
    coarse field; chunking rescaled to the coarse z extent)."""
    if lev.level == 0:
        return base
    chunk_z = base.chunk_z
    if chunk_z is not None:
        chunk_z = max(1, chunk_z // lev.stride)
    return base.replace(field=hierarchy.decimate(lev.level), grid=None,
                        chunk_z=chunk_z)


def _attach_meta(res, req: TopoRequest, fine_dims, lev: Level):
    """Stamp the guarantee onto a finished result and point its
    provenance at the original fine request."""
    nx, ny, nz = fine_dims
    res.arrays()[APPROX_META] = np.asarray(
        [lev.bound, lev.level, lev.stride, nx, ny, nz], dtype=np.float64)
    res.request = strip_field(req)
    return res


def _only_level_zero(req: TopoRequest, epsilon: float) -> bool:
    """True when no coarse level can meet ``epsilon``: bounds grow with
    coarseness, so one stride-2 pass (the level-1 bound) decides.
    Sources skip the probe (it would cost the hierarchy's own pass)."""
    if not all(d == 1 or d > 2 for d in req.grid.dims):
        return True          # the hierarchy would offer only level 0
    if _is_source(req.field):
        return False
    nx, ny, nz = req.grid.dims
    mn, mx = block_minmax(req.field.reshape(nz, ny, nx), 2)
    return level_bound(mn, mx) > epsilon


def approximate(pipeline, request, *, epsilon: Optional[float] = None,
                level: Optional[int] = None,
                hierarchy: Optional[Hierarchy] = None):
    """One bounded-error diagram of ``request`` through ``pipeline``.

    Exactly one of ``epsilon`` (the coarsest level whose bound meets it;
    defaults to ``request.epsilon``) or ``level`` selects the
    resolution."""
    req = _as_resolved(pipeline, request, hierarchy)
    if epsilon is None and level is None:
        epsilon = req.epsilon
    if epsilon is None and level is None:
        raise ValueError("approximate() needs epsilon= or level= "
                         "(or a request carrying epsilon)")
    if epsilon is not None and level is not None:
        raise ValueError("pass epsilon= or level=, not both")
    base = _base_request(req)
    lev0 = Level(0, 1, req.grid.dims, 0.0)
    if hierarchy is None and (
            level == 0 or (level is None and (
                epsilon == 0 or _only_level_zero(req, epsilon)))):
        # only level 0 qualifies: the exact pipeline, no pyramid
        return _attach_meta(pipeline.run(base), req, req.grid.dims, lev0)
    h = hierarchy if hierarchy is not None \
        else build_hierarchy(pipeline, req)
    lev = h.level(level) if level is not None else h.pick_level(epsilon)
    res = pipeline.run(_level_request(base, h, lev))
    return _attach_meta(res, req, h.grid.dims, lev)
