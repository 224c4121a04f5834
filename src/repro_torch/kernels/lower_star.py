"""Wrappers of the two CUDA lower-star gradient kernels.

- :func:`fused_lower_star_gradient` — ``csrc/fused.cu``, the production
  front-end (replaces the fused Pallas kernel ``_fused_call``,
  ``src/repro/kernels/lower_star.py:255``): a block stages a window of
  the unpadded order tensor in shared memory, and one thread per vertex
  takes its star neighbours from there and pairs its lower star; no
  (nv, 27) tensor and no padded volume is written.
- :func:`lower_star_gradient_prepass` — ``csrc/prepass.cu`` (replaces
  ``_prepass_call``, ``lower_star.py:170``): the same pairing over an
  (n, 27) neighbour tensor gathered beforehand with
  :func:`repro_torch.core.gradient.neighbor_orders`; the cross-check.
- :func:`fused_rows_from_halo_volume` — the halo entry of ``csrc/fused.cu``
  (replaces ``fused_rows_from_halo_volume``, ``lower_star.py:325``): the
  rows of the owned planes of one z-slab's (nzl+2, ny, nx) key volume
  whose first and last planes are ghosts; the streaming engines
  (``repro_torch.stream``) launch it once per chunk.

All return packed rows: status (n, 74) int8, partner (n, 74) int8,
vstat (n,) int8, vpart (n,) int32.  On tensors that lie on the CPU the
wrappers run the plain version (:func:`.ref.lower_star_gradient_torch`);
on CUDA tensors they launch the kernel on the current stream or raise —
there is no fallback.  ``LAUNCHES`` counts kernel launches;
:func:`kernel_attrs` reports each kernel's launch shape and resources.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.gradient import neighbor_orders
from repro_torch.core.grid import Grid
from . import build
from .ref import R, lower_star_gradient_torch

# kernel launches per wrapper; chip_smoke.py zeroes and reads these.  The
# sharded streaming engine launches from several threads, so counts go
# through _count.
LAUNCHES = {"fused": 0, "prepass": 0, "fused_halo": 0}
_LAUNCH_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1

_P = ctypes.c_void_p
_ARGTYPES = {
    "ls_fused": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, _P, _P, _P, _P, _P],
    "ls_prepass": [_P, _P, ctypes.c_longlong, _P, _P, _P, _P, _P],
    "ls_fused_halo": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      _P, _P, _P, _P, _P],
}
# kernel name -> the library (csrc/<name>.cu) that holds it
_LIBRARY = {"fused": "fused", "prepass": "prepass", "fused_halo": "fused"}


_SUFFIX = {torch.int32: "i32", torch.int64: "i64"}


def _cfun(lib_name: str, fn: str, dtype: torch.dtype):
    f = getattr(build.library(lib_name), f"{fn}_{_SUFFIX[dtype]}")
    f.argtypes = _ARGTYPES[fn]
    f.restype = ctypes.c_int
    return f


def kernel_attrs(name: str, dtype: torch.dtype) -> dict:
    """Launch shape and resources of kernel ``name`` ("fused", "prepass"
    or "fused_halo") for int32 or int64 ranks, as the CUDA runtime reports
    them (builds the kernel at first use; needs a CUDA device)."""
    f = getattr(build.library(_LIBRARY[name]),
                f"ls_{name}_attrs_{_SUFFIX[dtype]}")
    f.argtypes = [_P]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _raise_on(f(ctypes.cast(out, _P)), f"{name} attributes")
    return dict(zip(("block", "registers", "stack_bytes", "static_smem",
                     "dynamic_smem", "blocks_per_sm"), out))


def _maybe_int32(x: torch.Tensor, rank_bound) -> torch.Tensor:
    """int32 ranks whenever the bound allows (half the bytes of int64)."""
    if rank_bound is not None and int(rank_bound) < 2 ** 31:
        return x.to(torch.int32)
    return x


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA or CPU tensor, got {t.device}")
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"ranks must be int32 or int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ranks must be contiguous")


def _outputs(n: int, device):
    return (torch.empty((n, R), dtype=torch.int8, device=device),
            torch.empty((n, R), dtype=torch.int8, device=device),
            torch.empty(n, dtype=torch.int8, device=device),
            torch.empty(n, dtype=torch.int32, device=device))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel call failed: cudaError {err}")


def fused_lower_star_gradient(grid: Grid, orders: torch.Tensor, *,
                              rank_bound: int | None = None):
    """Fused gather + pairing over a whole grid or a batch of them.

    orders: (nv,) or (B, nv) rank fields in vid layout.  ``rank_bound``
    defaults to ``grid.nv``; below 2**31 the ranks go to the kernel as
    int32.  Returns packed rows over the flattened batch."""
    nx, ny, nz = grid.dims
    rank_bound = grid.nv if rank_bound is None else rank_bound
    o = _maybe_int32(orders.reshape(-1, grid.nv), rank_bound)
    if o.device.type == "cpu":
        nbrs = torch.cat([neighbor_orders(grid, ob) for ob in o])
        return lower_star_gradient_torch(nbrs, o.reshape(-1), rank_bound)
    _check_cuda(o)
    B = o.shape[0]
    outs = _outputs(B * grid.nv, o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = _cfun("fused", "ls_fused", o.dtype)(
            o.data_ptr(), B, nz, ny, nx, *(t.data_ptr() for t in outs),
            stream)
    _raise_on(err, "fused")
    _count("fused")
    return outs


def lower_star_gradient_prepass(nbrs: torch.Tensor, ov: torch.Tensor, *,
                                rank_bound: int | None = None):
    """Pairing over a pre-gathered (n, 27) neighbour-order tensor.

    nbrs (n, 27), ov (n,).  ``rank_bound`` (= ``grid.nv``) selects int32
    ranks below 2**31 (and the packed-key path of the plain version below
    2**21).  No bucket padding: a CUDA launch takes any n."""
    nbrs = _maybe_int32(nbrs, rank_bound)
    ov = _maybe_int32(ov, rank_bound)
    if nbrs.dim() != 2 or nbrs.shape[1] != 27 or ov.shape != nbrs.shape[:1]:
        raise ValueError(f"expected nbrs (n, 27) and ov (n,), got "
                         f"{tuple(nbrs.shape)} and {tuple(ov.shape)}")
    if nbrs.device.type == "cpu":
        return lower_star_gradient_torch(nbrs, ov, rank_bound)
    _check_cuda(nbrs, ov)
    if ov.dtype != nbrs.dtype or ov.device != nbrs.device:
        raise TypeError("nbrs and ov must share dtype and device")
    n = nbrs.shape[0]
    outs = _outputs(n, nbrs.device)
    with torch.cuda.device(nbrs.device):
        stream = torch.cuda.current_stream(nbrs.device).cuda_stream
        err = _cfun("prepass", "ls_prepass", nbrs.dtype)(
            nbrs.data_ptr(), ov.data_ptr(), n,
            *(t.data_ptr() for t in outs), stream)
    _raise_on(err, "prepass")
    _count("prepass")
    return outs


def halo_owned_neighbors(ext: torch.Tensor):
    """(nbrs (nzl*ny*nx, 27), ov (nzl*ny*nx,)) of the owned vertices of a
    (nzl+2, ny, nx) ext volume: the stencil gather over the ext grid, with
    the two ghost planes' rows dropped."""
    nzh, ny, nx = ext.shape
    nbrs = neighbor_orders(Grid.of(nx, ny, nzh), ext.reshape(-1))
    return (nbrs.reshape(nzh, ny * nx, 27)[1:-1].reshape(-1, 27),
            ext[1:-1].reshape(-1))


def fused_rows_from_halo_volume(ext: torch.Tensor, *,
                                rank_bound: int | None = None):
    """Fused gather + pairing for the owned planes of one z-slab.

    ext: (nzl+2, ny, nx) order or key volume whose first and last planes
    are ghosts (the neighbouring slab's keys, -1 at the grid's boundary).
    Rank-free (value, vid) keys stay int64 with ``rank_bound=None``.
    Returns packed rows of the nzl*ny*nx owned vertices in vid order."""
    if ext.dim() != 3 or ext.shape[0] < 3:
        raise ValueError(f"expected an (nzl+2, ny, nx) volume with nzl >= 1, "
                         f"got {tuple(ext.shape)}")
    ext = _maybe_int32(ext, rank_bound)
    if ext.device.type == "cpu":
        nbrs, ov = halo_owned_neighbors(ext)
        return lower_star_gradient_torch(nbrs, ov, rank_bound)
    ext = ext.contiguous()
    _check_cuda(ext)
    nzh, ny, nx = ext.shape
    outs = _outputs((nzh - 2) * ny * nx, ext.device)
    with torch.cuda.device(ext.device):
        stream = torch.cuda.current_stream(ext.device).cuda_stream
        err = _cfun("fused", "ls_fused_halo", ext.dtype)(
            ext.data_ptr(), nzh - 2, ny, nx, *(t.data_ptr() for t in outs),
            stream)
    _raise_on(err, "fused halo")
    _count("fused_halo")
    return outs
