"""The check of a D0 request of ``PersistencePipeline.run``.

It compares the vertex order, the critical cells (the minima and the
critical edges by identity, the critical triangles and tets counted at
each vertex of the grid), the D0 pairs and the essential minima.  Every
limit is 0: the configuration states an exact result (the order, the
critical cells and the D0 pairs of the sequential DMS), and the program
either gives it or does not.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench import reference as R

LIMITS = {"order_mismatch": 0, "critical_vertex_mismatch": 0,
          "critical_edge_mismatch": 0, "critical_cell_mismatch": 0,
          "d0_pair_mismatch": 0, "essential_mismatch": 0}


def program(res, gradient) -> dict:
    """What the check keeps of a request's answer, on the host: the
    order and the D0 pairs and essential minima of the result ``res``,
    and the critical simplices of each dimension of the gradient field
    the request's gradient stage made (none where the request made
    none: then no cell is critical)."""
    d = res.diagram
    none = torch.zeros(0, dtype=torch.int64)
    return {"order": d.order.cpu(),
            "critical": {k: none if gradient is None
                         else gradient.critical_sids(k).cpu()
                         for k in range(4)},
            "pairs": d.pairs[0].cpu(), "essential": d.essential[0].cpu()}


def _cells_at_vertices(kept, fr: R.Front, dims) -> torch.Tensor:
    """(nv, 2) critical triangles and tets counted at their highest
    vertex, by the reference's order."""
    if "cells_at_vertices" in kept:
        return kept["cells_at_vertices"].to(fr.rank.device).long()
    n = fr.rank.numel()
    cols = []
    for k in (2, 3):
        sid = kept["critical"][k].to(fr.rank.device).long()
        vs = R.simplex_vertices(sid, k, dims).clamp(0, n - 1)
        top = torch.gather(vs, 1, fr.rank[vs].argmax(1, keepdim=True))[:, 0]
        cols.append(torch.bincount(top, minlength=n))
    return torch.stack(cols, 1)


def compare(field: torch.Tensor, dims, kept: dict) -> Dict[str, tuple]:
    fr = R.front_reference(field, dims)
    dev = fr.rank.device
    got = {"order_mismatch": int((kept["order"].to(dev).reshape(-1).long()
                                  != fr.rank).sum())}
    got["critical_vertex_mismatch"] = R.set_difference(
        kept["critical"][0].to(dev).long(), fr.minima)
    got["critical_edge_mismatch"] = R.set_difference(
        kept["critical"][1].to(dev).long(), R._edge_sid(fr.sv, fr.sj, dims))
    got["critical_cell_mismatch"] = int(
        (_cells_at_vertices(kept, fr, dims) - fr.crit[:, 1:].long())
        .abs().sum())
    ref = R.d0_pairs(fr, dims)
    p = kept["pairs"].to(dev).long().reshape(-1, 2)
    got["d0_pair_mismatch"] = R.set_difference(
        p[:, 0] * (1 << 34) + p[:, 1],
        ref.pairs[:, 0] * (1 << 34) + ref.pairs[:, 1])
    got["essential_mismatch"] = R.set_difference(
        kept["essential"].to(dev).long().reshape(-1), ref.essential)
    return {k: (v, LIMITS[k]) for k, v in got.items()}


def control(field: torch.Tensor, dims, cfg=None, check_cfg=None,
            seed: int = 0, dtype=torch.bfloat16) -> dict:
    """The reference on the field rounded to ``dtype``, in the form that
    ``program`` keeps (the triangles and tets as counts at vertices)."""
    fr = R.front_reference(field.to(dtype).float(), dims)
    ref = R.d0_pairs(fr, dims)
    return {"order": fr.rank,
            "critical": {0: fr.minima, 1: R._edge_sid(fr.sv, fr.sj, dims)},
            "cells_at_vertices": fr.crit[:, 1:],
            "pairs": ref.pairs, "essential": ref.essential}
