"""Progressive refinement: coarse preview now, exact diagram on demand.

PyTorch counterpart of ``repro.approx.progressive``.
``refine(pipeline, request)`` walks the hierarchy coarsest first and
yields one guaranteed :class:`DiagramResult` per level, with error bounds
that never grow; the last level is the fine grid, so a fully drained
refinement ends byte-identical to ``pipeline.run`` of the progressive
request.

Stopping rules (at least one result is always yielded):

- ``epsilon`` — stop once a level's bound meets it;
- ``deadline_s`` — checked before each level after the first, against
  the time since the walk began.  Every level's run ends in a device
  synchronize, so the clock counts device time.

Levels whose bound does not improve on the previous one are skipped.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

from .engine import (_as_resolved, _attach_meta, _base_request,
                     _level_request, build_hierarchy)
from .hierarchy import Hierarchy


def refine(pipeline, request, *, epsilon: Optional[float] = None,
           deadline_s: Optional[float] = None,
           hierarchy: Optional[Hierarchy] = None) -> Iterator:
    """Yield successive bounded-error results, coarse to fine.

    ``epsilon`` / ``deadline_s`` default to the request's own; with
    neither, the walk ends at the exact diagram (``error_bound == 0.0``)."""
    req = _as_resolved(pipeline, request, hierarchy)
    if epsilon is None:
        epsilon = req.epsilon
    if deadline_s is None:
        deadline_s = req.deadline_s
    t0 = time.monotonic()
    h = hierarchy if hierarchy is not None \
        else build_hierarchy(pipeline, req)
    base = _base_request(req)
    last_bound = None
    for lev in reversed(h.levels):            # coarsest first
        if last_bound is not None:
            if deadline_s is not None \
                    and time.monotonic() - t0 > deadline_s:
                return
            if lev.level > 0 and lev.bound >= last_bound:
                continue                      # no tighter guarantee
        res = pipeline.run(_level_request(base, h, lev))
        yield _attach_meta(res, req, h.grid.dims, lev)
        last_bound = lev.bound
        if epsilon is not None and lev.bound <= epsilon:
            return


def approximate_progressive(pipeline, request, **kw):
    """Drain :func:`refine` and return its final (tightest) result."""
    res = None
    for res in refine(pipeline, request, **kw):
        pass
    return res
