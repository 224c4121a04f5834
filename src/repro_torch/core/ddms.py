"""Distributed Discrete Morse Sandwich entry point (paper Sec. III).

PyTorch counterpart of ``repro.core.ddms``.  ``compute_ddms_sim`` runs the
distributed back-end — the round-synchronous self-correcting
extremum-saddle pairing (Alg. 4) and the token-based D1 engine (Alg. 5/6)
over an ``n_blocks`` z-decomposition — and gives the same diagram as
the sequential DMS for every block count.  It is the thin wrapper

    compute_ddms_sim(grid, f, n_blocks=n)
        == PersistencePipeline(n_blocks=n, distributed=True).run(
               TopoRequest(field=f, grid=grid))

The distributed front-end (sample sort, halo exchange, ring resolution)
is ``repro_torch.distributed.shardmap_pipeline``, the ``shardmap``
gradient backend of the pipeline.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .dms import DMSResult
from .grid import Grid


def compute_ddms_sim(grid: Grid, f: np.ndarray, n_blocks: int = 4,
                     anticipation: bool = True, budget: Optional[int] = None,
                     gradient_backend: str = "fused",
                     device: Optional[str] = None) -> DMSResult:
    """Distributed DMS via the pipeline (see module docstring)."""
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    res = PersistencePipeline(backend=gradient_backend, n_blocks=n_blocks,
                              distributed=True, anticipation=anticipation,
                              budget=budget, device=device).run(
        TopoRequest(field=f, grid=grid))
    stats = dict(res.stats)
    stats.setdefault("n_blocks", n_blocks)
    return DMSResult(res.diagram, stats)
