"""Single-node Discrete Morse Sandwich entry point (paper Sec. II-F).

The stage chain lives in :mod:`repro_torch.pipeline`; ``compute_dms`` is
the thin wrapper kept from the reference:

    compute_dms(grid, f)  ==  PersistencePipeline().run(
                                  TopoRequest(field=f, grid=grid))
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from .diagram import Diagram
from .grid import Grid


@dataclass
class DMSResult:
    diagram: Diagram
    stats: Dict[str, float] = field(default_factory=dict)


def as_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 2) rows (a, b) sorted lexicographically, int64."""
    rows = torch.stack([a.long(), b.long()], dim=1).reshape(-1, 2)
    rows = rows[torch.argsort(rows[:, 1], stable=True)]
    return rows[torch.argsort(rows[:, 0], stable=True)]


def compute_dms(grid: Grid, f: np.ndarray, gradient_backend: str = "fused",
                device: Optional[str] = None) -> DMSResult:
    """Sequential DMS via the pipeline (see module docstring)."""
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    res = PersistencePipeline(backend=gradient_backend, device=device) \
        .run(TopoRequest(field=f, grid=grid))
    return DMSResult(res.diagram, res.stats)
