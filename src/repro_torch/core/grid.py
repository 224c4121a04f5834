"""Implicit Freudenthal (Kuhn) triangulation of regular grids (1-D, 2-D, 3-D).

PyTorch counterpart of ``repro.core.grid``.  A regular grid of shape
``dims`` is decomposed into simplices without ever materializing them;
every simplex has the dense id

    sid = base_vertex_id * T_k + type_index

with ``T_k`` = 1, 7, 12, 6 simplex types for k = 0..3 and the base vertex
the lexicographically smallest vertex of the simplex.  (base, type)
combinations that fall outside the grid are *invalid* and masked.

The type tables (``VERTS``, ``SPAN``, ``FACES``, ``COFACES``, ``STAR``,
``OTHERS``, ``STAR_FACES``, ``STAR_COFACES``) are tiny numpy constants
built at import time by the same construction as the reference; the
:class:`Grid` queries take and return torch tensors on the device of
their ``sid``/``v`` argument.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Type tables
# --------------------------------------------------------------------------

_NONZERO = [np.array(b, dtype=np.int8) for b in itertools.product((0, 1), repeat=3)
            if any(b)]


def _build_types() -> Dict[int, np.ndarray]:
    """VERTS[k]: (T_k, k+1, 3) cumulative vertex offsets for each type."""
    verts: Dict[int, np.ndarray] = {0: np.zeros((1, 1, 3), dtype=np.int8)}
    for k in (1, 2, 3):
        chains: List[np.ndarray] = []
        for parts in itertools.product(_NONZERO, repeat=k):
            tot = np.sum(parts, axis=0)
            if tot.max() > 1:  # parts must have disjoint supports
                continue
            cum = np.zeros((k + 1, 3), dtype=np.int8)
            for i, p in enumerate(parts):
                cum[i + 1] = cum[i] + p
            chains.append(cum)
        verts[k] = np.stack(chains)
    return verts


VERTS: Dict[int, np.ndarray] = _build_types()
NTYPES: Dict[int, int] = {k: v.shape[0] for k, v in VERTS.items()}  # {0:1,1:7,2:12,3:6}
SPAN: Dict[int, np.ndarray] = {k: VERTS[k][:, -1, :].copy() for k in VERTS}
MAXDIM = 3

_TYPE_LOOKUP: Dict[int, Dict[bytes, int]] = {
    k: {VERTS[k][t].tobytes(): t for t in range(NTYPES[k])} for k in VERTS
}


def _build_faces() -> Dict[int, np.ndarray]:
    faces: Dict[int, np.ndarray] = {}
    for k in (1, 2, 3):
        out = np.zeros((NTYPES[k], k + 1, 4), dtype=np.int8)
        for t in range(NTYPES[k]):
            chain = VERTS[k][t]
            for j in range(k + 1):
                sub = np.delete(chain, j, axis=0)
                shift = sub[0].copy()
                rel = (sub - sub[0]).astype(np.int8)
                out[t, j, 0] = _TYPE_LOOKUP[k - 1][rel.tobytes()]
                out[t, j, 1:] = shift
        faces[k] = out
    return faces


FACES: Dict[int, np.ndarray] = _build_faces()


def _build_cofaces() -> Dict[int, np.ndarray]:
    cof: Dict[int, np.ndarray] = {}
    for k in (0, 1, 2):
        lists: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(NTYPES[k])]
        for ct in range(NTYPES[k + 1]):
            for j in range(k + 2):
                ft = int(FACES[k + 1][ct, j, 0])
                shift = FACES[k + 1][ct, j, 1:]
                # coface of (ft, b) is (ct, b - shift)
                lists[ft].append((ct, -int(shift[0]), -int(shift[1]), -int(shift[2])))
        ncof = max(len(l) for l in lists)
        out = np.full((NTYPES[k], ncof, 4), -1, dtype=np.int8)
        for ft, l in enumerate(lists):
            for i, entry in enumerate(l):
                out[ft, i] = entry
        cof[k] = out
    return cof


COFACES: Dict[int, np.ndarray] = _build_cofaces()
NCOF: Dict[int, int] = {k: v.shape[1] for k, v in COFACES.items()}


def _build_star() -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    star: Dict[int, np.ndarray] = {}
    others: Dict[int, np.ndarray] = {}
    for k in (0, 1, 2, 3):
        rows = []
        oth = []
        for t in range(NTYPES[k]):
            for j in range(k + 1):
                shift = VERTS[k][t][j]
                rows.append((t, int(shift[0]), int(shift[1]), int(shift[2])))
                o = np.delete(VERTS[k][t], j, axis=0) - shift
                oth.append(o.astype(np.int8))
        star[k] = np.array(rows, dtype=np.int8)
        others[k] = (np.stack(oth) if k > 0
                     else np.zeros((1, 0, 3), dtype=np.int8))
    return star, others


STAR, OTHERS = _build_star()
NSTAR: Dict[int, int] = {k: STAR[k].shape[0] for k in STAR}  # {0:1,1:14,2:36,3:24}


def _build_star_faces() -> Dict[int, np.ndarray]:
    """STAR_FACES[k][r] = local rows (into STAR[k-1]) of the faces of star
    row r that contain v; row r is (t = r // (k+1), j = r % (k+1))."""
    sf: Dict[int, np.ndarray] = {}
    for k in (1, 2, 3):
        out = np.full((NSTAR[k], k), -1, dtype=np.int8)
        for r in range(NSTAR[k]):
            t, j = divmod(r, k + 1)
            shift = VERTS[k][t][j]  # simplex base = v - shift
            m = 0
            for fj in range(k + 1):
                if fj == j:
                    continue  # dropping v itself -> face without v
                ft = int(FACES[k][t, fj, 0])
                fshift = FACES[k][t, fj, 1:]
                want = (shift - fshift).astype(np.int8)
                jj = next(c for c in range(k)
                          if np.array_equal(VERTS[k - 1][ft][c], want))
                out[r, m] = ft * k + jj
                m += 1
        sf[k] = out
    return sf


STAR_FACES: Dict[int, np.ndarray] = _build_star_faces()


def _build_star_cofaces() -> Dict[int, np.ndarray]:
    sc: Dict[int, np.ndarray] = {}
    for k in (0, 1, 2):
        lists: List[List[int]] = [[] for _ in range(NSTAR[k])]
        for r in range(NSTAR[k + 1]):
            for m in range(k + 1):
                lists[int(STAR_FACES[k + 1][r, m])].append(r)
        n = max(len(l) for l in lists)
        out = np.full((NSTAR[k], n), -1, dtype=np.int8)
        for fr, l in enumerate(lists):
            out[fr, : len(l)] = l
        sc[k] = out
    return sc


STAR_COFACES: Dict[int, np.ndarray] = _build_star_cofaces()


@functools.lru_cache(maxsize=None)
def _device_table(name: str, k: int, device: torch.device) -> torch.Tensor:
    """int64 copy of a type table on ``device`` (cached per device)."""
    tab = {"VERTS": VERTS, "SPAN": SPAN, "FACES": FACES,
           "COFACES": COFACES}[name][k]
    return torch.as_tensor(tab.astype(np.int64), device=device)


def table(name: str, k: int, device) -> torch.Tensor:
    return _device_table(name, k, torch.device(device))


# --------------------------------------------------------------------------
# Grid object
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Grid:
    """A regular grid with implicit Freudenthal triangulation.

    ``dims`` is the vertex count per axis, canonicalized to length 3 with
    trailing 1s; ``dim`` is the complex dimension (axes longer than 1).
    """

    dims: Tuple[int, int, int]

    @staticmethod
    def of(*dims: int) -> "Grid":
        d = tuple(int(x) for x in dims)
        if not (1 <= len(d) <= 3 and all(x >= 1 for x in d)):
            raise ValueError(f"grid dims must be 1 to 3 positive ints, got {d}")
        while len(d) < 3:
            d = d + (1,)
        return Grid(d)

    # -- basic counts ------------------------------------------------------
    @property
    def nv(self) -> int:
        return int(np.prod(self.dims))

    @property
    def dim(self) -> int:
        return int(sum(1 for x in self.dims if x > 1))

    @property
    def strides(self) -> Tuple[int, int, int]:
        nx, ny, _ = self.dims
        return (1, nx, nx * ny)

    def n_simplices(self, k: int) -> int:
        """Number of *valid* k-simplices."""
        dims = np.array(self.dims)
        return int(np.prod(np.maximum(dims[None, :] - SPAN[k], 0), axis=1).sum())

    def sid_space(self, k: int) -> int:
        """Size of the dense id space for dimension k (includes invalid)."""
        return self.nv * NTYPES[k]

    # -- coordinates ---------------------------------------------------------
    def vid_to_xyz(self, vid: torch.Tensor):
        nx, ny, _ = self.dims
        return vid % nx, (vid // nx) % ny, vid // (nx * ny)

    def xyz_to_vid(self, x, y, z):
        nx, ny, _ = self.dims
        return x + nx * (y + ny * z)

    def in_bounds(self, x, y, z):
        nx, ny, nz = self.dims
        return (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)

    # -- simplex queries (torch tensors in, torch tensors out) ----------------
    def simplex_base_type(self, k: int, sid: torch.Tensor):
        return sid // NTYPES[k], sid % NTYPES[k]

    def simplex_valid(self, k: int, sid: torch.Tensor) -> torch.Tensor:
        sid = sid.long()
        base, t = self.simplex_base_type(k, sid)
        x, y, z = self.vid_to_xyz(base)
        span = table("SPAN", k, sid.device)[t]
        nx, ny, nz = self.dims
        ok = (x + span[..., 0] <= nx - 1) & (y + span[..., 1] <= ny - 1) \
            & (z + span[..., 2] <= nz - 1)
        return ok & (sid >= 0)

    def simplex_vertices(self, k: int, sid: torch.Tensor) -> torch.Tensor:
        """(..., k+1) vertex ids of each simplex (undefined where invalid)."""
        sid = sid.long()
        base, t = self.simplex_base_type(k, sid)
        x, y, z = self.vid_to_xyz(base)
        off = table("VERTS", k, sid.device)[t]               # (..., k+1, 3)
        return self.xyz_to_vid(x[..., None] + off[..., 0],
                               y[..., None] + off[..., 1],
                               z[..., None] + off[..., 2])

    def simplex_faces(self, k: int, sid: torch.Tensor) -> torch.Tensor:
        """(..., k+1) sids of the faces of each k-simplex."""
        sid = sid.long()
        base, t = self.simplex_base_type(k, sid)
        x, y, z = self.vid_to_xyz(base)
        e = table("FACES", k, sid.device)[t]                 # (..., k+1, 4)
        fb = self.xyz_to_vid(x[..., None] + e[..., 1], y[..., None] + e[..., 2],
                             z[..., None] + e[..., 3])
        return fb * NTYPES[k - 1] + e[..., 0]

    def simplex_cofaces(self, k: int, sid: torch.Tensor) -> torch.Tensor:
        """(..., NCOF_k) sids of the cofaces (-1 where padded/out of grid)."""
        sid = sid.long()
        base, t = self.simplex_base_type(k, sid)
        x, y, z = self.vid_to_xyz(base)
        e = table("COFACES", k, sid.device)[t]
        cx = x[..., None] + e[..., 1]
        cy = y[..., None] + e[..., 2]
        cz = z[..., None] + e[..., 3]
        ct = e[..., 0]
        csid = self.xyz_to_vid(cx, cy, cz) * NTYPES[k + 1] + ct
        pad = ct < 0
        st = table("SPAN", k + 1, sid.device)[torch.where(pad, 0, ct)]
        nx, ny, nz = self.dims
        valid = ~pad & self.in_bounds(cx, cy, cz) \
            & (cx + st[..., 0] <= nx - 1) & (cy + st[..., 1] <= ny - 1) \
            & (cz + st[..., 2] <= nz - 1)
        return torch.where(valid, csid, -1)

    def simplex_key(self, k: int, sid: torch.Tensor,
                    order: torch.Tensor) -> torch.Tensor:
        """(..., k+1) vertex orders sorted descending — the lexicographic
        comparison key (paper Sec. II-A)."""
        o = order[self.simplex_vertices(k, sid)]
        return torch.sort(o, dim=-1, descending=True).values

    def simplex_max_vertex(self, k: int, sid: torch.Tensor,
                           order: torch.Tensor) -> torch.Tensor:
        v = self.simplex_vertices(k, sid)
        if v.numel() == 0:
            return v.reshape(v.shape[:-1])
        return torch.gather(v, -1, order[v].argmax(-1, keepdim=True))[..., 0]


def vertex_order(f: torch.Tensor) -> torch.Tensor:
    """Global injective vertex order: rank by (f, vid) ascending, int64.

    ``f + 0.0`` turns ``-0.0`` into ``+0.0`` before the stable sort, so the
    two zeros tie and fall back to vid order as in numpy's stable argsort
    (a radix sort on float bits would otherwise rank ``-0.0`` first).  NaNs
    sort after every number, in vid order, as numpy sorts them.
    """
    f = f.reshape(-1) + 0.0
    perm = torch.argsort(f, stable=True)
    order = torch.empty(f.shape[0], dtype=torch.int64, device=f.device)
    order[perm] = torch.arange(f.shape[0], dtype=torch.int64, device=f.device)
    return order
