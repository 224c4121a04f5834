"""Front-end dispatch over the lower-star gradient implementations.

``backend``:

- ``"fused"``   — the fused CUDA kernel (``csrc/fused.cu``): the 27-point
  gather happens inside the kernel, no (nv, 27) tensor is written;
- ``"prepass"`` — :func:`neighbor_orders` writes the (nv, 27) tensor,
  then the prepass CUDA kernel (``csrc/prepass.cu``) pairs it;
- ``"torch"``   — the same gather, then the plain PyTorch version on
  whatever device the ranks are on.

On CPU tensors the two kernel wrappers run the plain version themselves.
:func:`rows_batch` takes whole grids; :func:`lower_star_rows_halo` takes
the halo-extended key volume of one z-slab (the streaming entry).
"""

from __future__ import annotations

import torch

from repro_torch.core.gradient import NROWS, neighbor_orders
from repro_torch.core.grid import Grid
from .lower_star import (_maybe_int32, fused_lower_star_gradient,
                         fused_rows_from_halo_volume, halo_owned_neighbors,
                         lower_star_gradient_prepass)
from .ref import lower_star_gradient_torch

BACKENDS = ("fused", "prepass", "torch")


def gradient_hbm_model(dims, rank_bytes=None):
    """Modelled device-memory bytes per vertex of each front-end path on
    an H100: the rank reads and the gathered tensor (``read``) and the
    packed rows written (``write``, 74 + 74 + 1 + 4 = 153 B).

    Rank width follows the code: int32 when ``nv < 2**31``.

    - ``prepass``: the gather reads the order field and writes a (nv, 27)
      rank tensor; the kernel reads that back: 27w + 27w + w.
    - ``fused``: a block of 128 vertices loads a window of nine runs of
      130 ranks into shared memory; neighbouring blocks share those runs
      through L2, so device memory sees each rank about once: w.
    """
    nx, ny, nz = dims
    if rank_bytes is None:
        rank_bytes = 4.0 if nx * ny * nz < 2 ** 31 else 8.0
    w = float(rank_bytes)
    write = 2 * NROWS + 1 + 4
    return {"prepass": {"read": 27 * w + w, "write": 27 * w + write},
            "fused": {"read": w, "write": write}}


def rows_batch(grid: Grid, orders: torch.Tensor, backend: str = "fused"):
    """Packed gradient rows of B same-grid rank fields (B, nv), over the
    flattened batch: status (B*nv, 74), partner, vstat, vpart."""
    orders = orders.reshape(-1, grid.nv)
    if backend == "fused":
        return fused_lower_star_gradient(grid, orders)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    o = _maybe_int32(orders, grid.nv)
    nbrs = torch.cat([neighbor_orders(grid, ob) for ob in o])
    if backend == "prepass":
        return lower_star_gradient_prepass(nbrs, o.reshape(-1),
                                           rank_bound=grid.nv)
    return lower_star_gradient_torch(nbrs, o.reshape(-1), rank_bound=grid.nv)


def lower_star_gradient(grid: Grid, order: torch.Tensor,
                        backend: str = "fused"):
    """Per-vertex packed gradient rows of one field."""
    return rows_batch(grid, order.reshape(1, -1), backend)


def lower_star_rows_halo(ext: torch.Tensor, backend: str = "fused"):
    """Packed gradient rows for one halo-extended z-slab (streaming entry).

    ``ext`` is a chunk's (nzl+2, ny, nx) key volume with its ghost planes
    (-1 outside the grid); the rows are those of its owned planes.  Keys
    are rank-free int64 words, so every path runs with ``rank_bound=None``
    (no int32 narrowing, no packed keys in the plain version)."""
    if backend == "fused":
        return fused_rows_from_halo_volume(ext, rank_bound=None)
    if backend not in BACKENDS:
        raise ValueError(f"unknown streaming backend {backend!r}; expected "
                         f"{BACKENDS}")
    nbrs, ov = halo_owned_neighbors(ext)
    if backend == "prepass":
        return lower_star_gradient_prepass(nbrs, ov, rank_bound=None)
    return lower_star_gradient_torch(nbrs, ov, rank_bound=None)
