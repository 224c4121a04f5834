"""`DiagramResult` — a queryable persistence-diagram result.

PyTorch counterpart of ``repro.pipeline.result`` (the DDMS v1 wire format
is not ported yet: ROADMAP.md).  The result keeps the live
:class:`~repro_torch.core.diagram.Diagram` (device tensors) and the
:class:`StageReport`, and answers queries from small canonical numpy
arrays built once when the pipeline finishes (critical simplices only),
so a kept result does not pin the field or the dense arrays:
``pairs(dim, min_persistence=…, top_k=…, space=…)``, ``essential(dim)``,
``betti()`` and ``arrays()`` — the same names and contents as the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.diagram import Diagram

from .plan import Plan
from .request import TopoRequest
from .stages import StageReport


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@dataclass
class DiagramResult:
    """Diagram + stage report + queries over canonical arrays."""

    diagram: Optional[Diagram]
    stats: Dict[str, float] = field(default_factory=dict)
    report: Optional[StageReport] = None
    request: Optional[TopoRequest] = None
    plan: Optional[Plan] = None
    _arrays: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    # vertex ids (tensor) -> field values (tensor); None once built
    _values_fn: Optional[Callable] = field(default=None, repr=False)

    @property
    def grid_dims(self) -> Tuple[int, ...]:
        return self.diagram.grid.dims

    @property
    def homology_dims(self) -> Tuple[int, ...]:
        """Homology dimensions this result computed."""
        if self.plan is not None and self.plan.homology_dims:
            return self.plan.homology_dims
        return tuple(range(self.diagram.grid.dim + 1))

    def _build_arrays(self) -> None:
        """Canonical per-dimension arrays from the live diagram, sorted by
        (birth order, death order)."""
        dg, vf, req = self.diagram, self._values_fn, self.request
        order = dg.order
        out: Dict[str, np.ndarray] = {
            "grid_dims": np.asarray(dg.grid.dims, dtype=np.int64),
            "homology_dims": np.asarray(self.homology_dims, dtype=np.int64),
            "query_defaults": np.asarray(
                [np.nan if req is None or req.min_persistence is None
                 else req.min_persistence,
                 -1 if req is None or req.top_k is None else req.top_k],
                dtype=np.float64),
        }
        for p in self.homology_dims:
            pr = dg.pairs.get(p)
            if pr is None or len(pr) == 0:
                sids = np.zeros((0, 2), np.int64)
                ords = np.zeros((0, 2), np.int64)
                vals = np.zeros((0, 2), np.float64)
            else:
                bv, dv = dg.pair_max_vertices(p)
                ob, od = order[bv].long(), order[dv].long()
                idx = torch.argsort(od, stable=True)
                idx = idx[torch.argsort(ob[idx], stable=True)]
                sids = _np(pr.long()[idx])
                ords = _np(torch.stack([ob, od], dim=1)[idx])
                vals = (_np(torch.stack([vf(bv), vf(dv)], dim=1)[idx])
                        if vf is not None else None)
            out[f"d{p}.pairs_sids"] = sids
            out[f"d{p}.pairs_orders"] = ords
            if vals is not None:
                out[f"d{p}.pairs_values"] = vals
            es = dg.essential.get(p)
            if es is not None and len(es):
                ev = dg.essential_max_vertices(p)
                eo = order[ev].long()
                idx = torch.argsort(eo, stable=True)
                evals = _np(vf(ev)[idx]) if vf is not None else None
                es, eo = _np(es.long()[idx]), _np(eo[idx])
            else:
                es = np.zeros(0, np.int64)
                eo = np.zeros(0, np.int64)
                evals = np.zeros(0, np.float64) if vf is not None else None
            out[f"d{p}.essential_sids"] = es
            out[f"d{p}.essential_orders"] = eo
            if evals is not None:
                out[f"d{p}.essential_values"] = evals
        self._arrays = out

    def arrays(self) -> Dict[str, np.ndarray]:
        """The canonical named arrays (built on first use)."""
        if "grid_dims" not in self._arrays:
            self._build_arrays()
        return self._arrays

    def _dim_arrays(self, dim: int, kind: str, space: str) -> np.ndarray:
        if space not in ("value", "order"):
            raise ValueError(f"space must be 'value' or 'order', got {space!r}")
        if dim not in self.homology_dims:
            raise ValueError(
                f"dimension {dim} was not computed (homology_dims="
                f"{self.homology_dims})")
        key = f"d{dim}.{kind}_{'values' if space == 'value' else 'orders'}"
        arrs = self.arrays()
        if key not in arrs:
            raise ValueError("no field values attached to this result; "
                             "query with space='order' instead")
        return arrs[key]

    def pairs(self, dim: int = 0, *, min_persistence: Optional[float] = None,
              top_k: Optional[int] = None, space: str = "value") -> np.ndarray:
        """(n, 2) (birth, death) points of dimension ``dim``, sorted by
        descending persistence (ties by birth).  ``min_persistence`` keeps
        ``death - birth >=`` the threshold, ``top_k`` the k most
        persistent; defaults come from the request (its value-space
        ``min_persistence`` is not applied to order-space queries)."""
        req = self.request
        if min_persistence is None and space == "value" and req is not None:
            min_persistence = req.min_persistence
        if top_k is None and req is not None:
            top_k = req.top_k
        pts = self._dim_arrays(dim, "pairs", space)
        pers = pts[:, 1] - pts[:, 0]
        if min_persistence is not None and min_persistence > 0:
            keep = pers >= min_persistence
            pts, pers = pts[keep], pers[keep]
        idx = np.argsort(-pers, kind="stable")
        if top_k is not None:
            idx = idx[:top_k]
        return pts[idx]

    def essential(self, dim: int = 0, *, space: str = "value") -> np.ndarray:
        """(n,) birth coordinates of the infinite classes of ``dim``."""
        return self._dim_arrays(dim, "essential", space)

    def betti(self) -> Dict[int, int]:
        """Betti numbers = essential-class counts per computed dim."""
        arrs = self.arrays()
        return {p: len(arrs[f"d{p}.essential_sids"])
                for p in self.homology_dims}
