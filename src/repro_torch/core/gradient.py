"""Discrete gradient container, packed star tables and the rows scatter.

PyTorch counterpart of ``repro.core.gradient``.  The gradient is computed
per vertex by pairing the simplices of each lower star (Robins et al.
ProcessLowerStars); the pairing itself lives in ``repro_torch.kernels``
(the plain torch version in ``kernels.ref``, the CUDA kernels in
``kernels.lower_star``).  This module holds what surrounds it:

- ``PACKED``: the 74 packed star rows (rows 0..13 edges, 14..49
  triangles, 50..73 tetrahedra) with the 27-neighbourhood indices of each
  row's other vertices (``others``) and its faces that contain the vertex
  (``fid``);
- :func:`neighbor_orders`, the (nv, 27) stencil gather;
- :class:`GradientField`, dense pair/critical arrays as device tensors,
  with :func:`gradient_from_numpy` / :meth:`GradientField.to_numpy` to
  carry a gradient across from (and back to) numpy;
- :func:`scatter_results_batch`, packed rows -> GradientFields by flat
  index arithmetic on the device, and its chunked form for streamed runs
  (:func:`alloc_gradient` + :func:`scatter_rows_chunk`);
- :func:`check_gradient_valid`, the discrete-vector-field checks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import grid as G
from .grid import Grid

# --------------------------------------------------------------------------
# Packed star tables (concat layout over dims 1..3)
# --------------------------------------------------------------------------

NROWS = G.NSTAR[1] + G.NSTAR[2] + G.NSTAR[3]  # 74
ROW_OFF = {1: 0, 2: G.NSTAR[1], 3: G.NSTAR[1] + G.NSTAR[2]}  # {1:0, 2:14, 3:50}


def _nbr_index(off: np.ndarray) -> int:
    """Offset in {-1,0,1}^3 -> index into the 27-neighbourhood (x fastest)."""
    return int((off[0] + 1) + 3 * (off[1] + 1) + 9 * (off[2] + 1))


def _build_packed() -> Dict[str, np.ndarray]:
    row_dim = np.zeros(NROWS, dtype=np.int8)
    others = np.full((NROWS, 3), -1, dtype=np.int8)
    fid = np.full((NROWS, 3), -1, dtype=np.int8)
    row_type = np.zeros(NROWS, dtype=np.int8)
    row_shift = np.zeros((NROWS, 3), dtype=np.int8)
    for k in (1, 2, 3):
        off = ROW_OFF[k]
        for r in range(G.NSTAR[k]):
            row = off + r
            row_dim[row] = k
            t, _ = divmod(r, k + 1)
            row_type[row] = t
            row_shift[row] = G.STAR[k][r, 1:]
            for m in range(k):
                others[row, m] = _nbr_index(G.OTHERS[k][r, m])
            if k >= 2:
                for m in range(k):
                    fid[row, m] = ROW_OFF[k - 1] + int(G.STAR_FACES[k][r, m])
    return dict(row_dim=row_dim, others=others, fid=fid,
                row_type=row_type, row_shift=row_shift)


PACKED = _build_packed()

# status codes
NOT_L, AVAIL, TAIL, HEAD, CRIT = 0, 1, 2, 3, 4


# --------------------------------------------------------------------------
# Neighbour-order tensor (the stencil gather)
# --------------------------------------------------------------------------

def neighbor_orders(grid: Grid, order: torch.Tensor) -> torch.Tensor:
    """(nv, 27) orders of the 27-neighbourhood of every vertex; -1 outside.

    Column ``(dx+1) + 3*(dy+1) + 9*(dz+1)`` holds the neighbour at offset
    (dx, dy, dz), matching ``PACKED["others"]``."""
    nx, ny, nz = grid.dims
    pad = torch.full((nz + 2, ny + 2, nx + 2), -1, dtype=order.dtype,
                     device=order.device)
    pad[1:-1, 1:-1, 1:-1] = order.reshape(nz, ny, nx)
    cols = [pad[1 + dz: 1 + dz + nz, 1 + dy: 1 + dy + ny, 1 + dx: 1 + dx + nx]
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return torch.stack(cols, dim=-1).reshape(grid.nv, 27)


# --------------------------------------------------------------------------
# Gradient field container
# --------------------------------------------------------------------------

@dataclass
class GradientField:
    """Dense discrete gradient over the implicit complex (device tensors).

    ``pair_up[k][sid]``  = sid of the (k+1)-simplex pairing sid as tail (-1)
    ``pair_down[k][sid]``= sid of the (k-1)-simplex pairing sid as head (-1)
    ``crit[k][sid]``     = critical mask (only meaningful on valid sids)
    """

    grid: Grid
    pair_up: Dict[int, torch.Tensor]
    pair_down: Dict[int, torch.Tensor]
    crit: Dict[int, torch.Tensor]

    def critical_sids(self, k: int) -> torch.Tensor:
        """Ascending int64 sids of the critical k-simplices."""
        return torch.nonzero(self.crit[k]).reshape(-1)

    def n_critical(self) -> Dict[int, int]:
        return {k: int(self.crit[k].sum()) for k in self.crit}

    def to_numpy(self):
        """(pair_up, pair_down, crit) as dicts of numpy arrays."""
        return tuple({k: v.cpu().numpy() for k, v in d.items()}
                     for d in (self.pair_up, self.pair_down, self.crit))


def gradient_from_numpy(grid: Grid, pair_up, pair_down, crit,
                        device) -> GradientField:
    """A :class:`GradientField` on ``device`` from numpy pair/crit dicts
    (the inverse of :meth:`GradientField.to_numpy`)."""
    def conv(d):
        return {int(k): torch.as_tensor(np.asarray(v), device=device)
                for k, v in d.items()}
    return GradientField(grid, conv(pair_up), conv(pair_down), conv(crit))


@functools.lru_cache(maxsize=64)
def _row_sid_offsets_np(dims) -> Dict[int, np.ndarray]:
    nx, ny, _ = dims
    out: Dict[int, np.ndarray] = {}
    for k in (1, 2, 3):
        rows = slice(ROW_OFF[k], ROW_OFF[k] + G.NSTAR[k])
        sh = PACKED["row_shift"][rows].astype(np.int64)
        t = PACKED["row_type"][rows].astype(np.int64)
        lin = sh[:, 0] + nx * (sh[:, 1] + ny * sh[:, 2])
        out[k] = t - lin * G.NTYPES[k]
    return out


def row_sid_offsets(grid: Grid, device="cpu") -> Dict[int, torch.Tensor]:
    """Per-grid row -> sid linear offset tables.

    The sid of packed star row ``r`` (dim k) at vertex ``v`` is
    ``v * NTYPES[k] + off[k][r_local]`` with ``off[k][r] = row_type[r] -
    lin(row_shift[r]) * NTYPES[k]``; one (S_k,) int64 table per dimension
    turns the whole result scatter into flat index arithmetic."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in _row_sid_offsets_np(tuple(grid.dims)).items()}


def sid_dtype(grid: Grid, k: int) -> torch.dtype:
    """Smallest signed integer dtype that indexes dim-k sid space."""
    return torch.int32 if grid.sid_space(k) < 2 ** 31 else torch.int64


def scatter_results_batch(grid: Grid, status: torch.Tensor,
                          partner: torch.Tensor, vstatus: torch.Tensor,
                          vpartner: torch.Tensor, B: int = 1,
                          offsets: Optional[Dict[int, torch.Tensor]] = None,
                          ) -> List[GradientField]:
    """Turn packed rows of B stacked same-grid fields into GradientFields.

    status/partner are (B*nv, 74), vstatus/vpartner (B*nv,), all on one
    device; the scatter runs there as flat index arithmetic on the
    row->sid offset tables (the only Python loop is over the <= 3 simplex
    dimensions).  Pair arrays are int32 whenever the sid space fits."""
    dev = status.device
    nv = grid.nv
    d = grid.dim
    off = row_sid_offsets(grid, dev) if offsets is None else offsets
    space = {k: grid.sid_space(k) for k in range(d + 1)}
    # a pair array for dim k STORES sids of the adjacent dimension, so its
    # dtype is gated on that dimension's space
    pair_up = {k: torch.full((B * space[k],), -1, dtype=sid_dtype(grid, k + 1),
                             device=dev) for k in range(d)}
    pair_down = {k: torch.full((B * space[k],), -1,
                               dtype=sid_dtype(grid, k - 1), device=dev)
                 for k in range(1, d + 1)}
    crit = {k: torch.zeros(B * space[k], dtype=torch.bool, device=dev)
            for k in range(d + 1)}

    crit[0][:] = vstatus == CRIT
    # vertex-edge pairs: the flat pair_up destination of vertex i IS i
    vv = torch.nonzero(vstatus == TAIL).reshape(-1)
    if d >= 1 and len(vv):
        es = (vv % nv) * G.NTYPES[1] + off[1][vpartner[vv].long()]
        pair_up[0][vv] = es.to(pair_up[0].dtype)
        pair_down[1][(vv // nv) * space[1] + es] = (vv % nv).to(
            pair_down[1].dtype)

    for k in range(1, d + 1):
        st = status[:, ROW_OFF[k]: ROW_OFF[k] + G.NSTAR[k]]   # (N, S_k)
        vs, rs = torch.nonzero(st == CRIT, as_tuple=True)
        if len(vs):
            sids = (vs % nv) * G.NTYPES[k] + off[k][rs]
            crit[k][(vs // nv) * space[k] + sids] = True
        # every pair has exactly one head, so the head rows cover all
        # vectors of dim >= 1
        vs, rs = torch.nonzero(st == HEAD, as_tuple=True)
        if not len(vs):
            continue
        p = partner[vs, ROW_OFF[k] + rs].long()
        if k == 1:
            # partner -2 marks the edge paired with the vertex itself
            # (scattered above from vstatus); nothing else is legal
            if not bool((p == -2).all()):
                raise ValueError("a dim-1 head row must pair with its vertex")
            continue
        head_sid = (vs % nv) * G.NTYPES[k] + off[k][rs]
        face_sid = (vs % nv) * G.NTYPES[k - 1] + off[k - 1][p - ROW_OFF[k - 1]]
        b = vs // nv
        pair_down[k][b * space[k] + head_sid] = face_sid.to(pair_down[k].dtype)
        pair_up[k - 1][b * space[k - 1] + face_sid] = head_sid.to(
            pair_up[k - 1].dtype)

    return [GradientField(
        grid,
        {k: v[b * space[k]:(b + 1) * space[k]] for k, v in pair_up.items()},
        {k: v[b * space[k]:(b + 1) * space[k]] for k, v in pair_down.items()},
        {k: v[b * space[k]:(b + 1) * space[k]] for k, v in crit.items()})
        for b in range(B)]


def alloc_gradient(grid: Grid, device="cpu") -> GradientField:
    """Empty dense gradient arrays on ``device`` for the chunked scatter.

    Every pair entry starts -1 and every critical flag False; chunk
    scatters (:func:`scatter_rows_chunk`) fill them in.  Dtypes match
    :func:`scatter_results_batch`, so streamed and in-memory fields are
    alike."""
    d = grid.dim
    space = {k: grid.sid_space(k) for k in range(d + 1)}
    return GradientField(
        grid,
        {k: torch.full((space[k],), -1, dtype=sid_dtype(grid, k + 1),
                       device=device) for k in range(d)},
        {k: torch.full((space[k],), -1, dtype=sid_dtype(grid, k - 1),
                       device=device) for k in range(1, d + 1)},
        {k: torch.zeros(space[k], dtype=torch.bool, device=device)
         for k in range(d + 1)})


def scatter_rows_chunk(grid: Grid, gf: GradientField, status: torch.Tensor,
                       partner: torch.Tensor, vstatus: torch.Tensor,
                       vpartner: torch.Tensor, v0: int,
                       offsets: Optional[Dict[int, torch.Tensor]] = None
                       ) -> None:
    """Scatter the packed rows of one vertex chunk into ``gf`` in place.

    status/partner are (nc, 74) for the vertices [v0, v0 + nc) in vid
    order (a z-slab), on ``gf``'s device; the scatter is flat index
    arithmetic there, so the rows never leave it.  A simplex belongs to
    the lower star of exactly one vertex (its order-maximal one), so
    chunks write disjoint sids, and scattering the chunks in any order
    rebuilds the single-shot :func:`scatter_results_batch` result; a
    simplex based in a neighbouring slab (a row shift across the chunk's
    floor) lands there through the same arithmetic."""
    off = row_sid_offsets(grid, status.device) if offsets is None \
        else offsets
    d = grid.dim
    nc = vstatus.shape[0]
    gf.crit[0][v0:v0 + nc] = vstatus == CRIT
    vv = torch.nonzero(vstatus == TAIL).reshape(-1)
    if d >= 1 and len(vv):
        vg = vv + v0
        es = vg * G.NTYPES[1] + off[1][vpartner[vv].long()]
        gf.pair_up[0][vg] = es.to(gf.pair_up[0].dtype)
        gf.pair_down[1][es] = vg.to(gf.pair_down[1].dtype)

    for k in range(1, d + 1):
        st = status[:, ROW_OFF[k]: ROW_OFF[k] + G.NSTAR[k]]   # (nc, S_k)
        vs, rs = torch.nonzero(st == CRIT, as_tuple=True)
        if len(vs):
            gf.crit[k][(vs + v0) * G.NTYPES[k] + off[k][rs]] = True
        vs, rs = torch.nonzero(st == HEAD, as_tuple=True)
        if not len(vs):
            continue
        p = partner[vs, ROW_OFF[k] + rs].long()
        if k == 1:
            if not bool((p == -2).all()):
                raise ValueError("a dim-1 head row must pair with its vertex")
            continue
        head_sid = (vs + v0) * G.NTYPES[k] + off[k][rs]
        face_sid = (vs + v0) * G.NTYPES[k - 1] \
            + off[k - 1][p - ROW_OFF[k - 1]]
        gf.pair_down[k][head_sid] = face_sid.to(gf.pair_down[k].dtype)
        gf.pair_up[k - 1][face_sid] = head_sid.to(gf.pair_up[k - 1].dtype)


# --------------------------------------------------------------------------
# Validity checks
# --------------------------------------------------------------------------

def check_gradient_valid(grid: Grid, gf: GradientField,
                         order: torch.Tensor) -> None:
    """Raise AssertionError unless ``gf`` is a valid discrete vector field
    local to lower stars whose critical counts have Euler characteristic 1."""
    d = grid.dim
    dev = gf.crit[0].device
    for k in range(d + 1):
        valid = grid.simplex_valid(k, torch.arange(grid.sid_space(k),
                                                   device=dev))
        up = gf.pair_up.get(k)
        down = gf.pair_down.get(k)
        n_roles = gf.crit[k].to(torch.int8)
        if up is not None:
            n_roles = n_roles + (up >= 0)
        if down is not None:
            n_roles = n_roles + (down >= 0)
        if not bool((n_roles[valid] == 1).all()):
            raise AssertionError(f"dim {k}: role violation")
        if not bool((n_roles[~valid] == 0).all()):
            raise AssertionError(f"dim {k}: invalid simplex used")
        if up is None:
            continue
        sids = torch.nonzero(up >= 0).reshape(-1)
        heads = up[sids].long()
        if not bool((gf.pair_down[k + 1][heads].long() == sids).all()):
            raise AssertionError(f"dim {k}: pairing is not an involution")
        faces = grid.simplex_faces(k + 1, heads)
        if not bool((faces == sids[:, None]).any(dim=1).all()):
            raise AssertionError(f"dim {k}: pair not incident")
        mv_t = grid.simplex_max_vertex(k, sids, order)
        mv_h = grid.simplex_max_vertex(k + 1, heads, order)
        if not bool((mv_t == mv_h).all()):
            raise AssertionError(f"dim {k}: pair leaves lower star")
    chi = euler_characteristic(gf)
    if chi != 1:
        raise AssertionError(f"critical Euler characteristic {chi} != 1")


def euler_characteristic(gf: GradientField) -> int:
    """Alternating sum of the critical counts per dimension."""
    return sum((-1) ** k * int(c.sum()) for k, c in gf.crit.items())
