"""Backend registries: gradient front-ends and sandwich back-ends.

PyTorch counterpart of ``repro.pipeline.backends``.

Gradient backends (a :class:`Backend` bundles ``rows(grid, orders (B, nv))
-> packed rows`` and derives ``gradient(grid, order) -> GradientField``;
its :class:`BackendCaps` say what else it offers — ``streamed``: a kernel
for one halo-extended z-slab, ``kernels.ops.lower_star_rows_halo``;
``sharded``: rows computed per z-slab block, ``rows(grid, orders,
n_blocks=n)``):

- ``np``       — literal Robins ProcessLowerStars with priority queues, per
  vertex on the host (the reference's oracle; chosen only by name);
- ``fused``    — the fused CUDA lower-star kernel (default);
- ``prepass``  — the (nv, 27) gather + the prepass CUDA kernel;
- ``torch``    — the same gather + the plain PyTorch pairing;
- ``shardmap`` — the distributed front-end's gradient step
  (``distributed.shardmap_pipeline.halo_gradient``) over the block ring
  of ``n_blocks`` z-slabs (``distributed.block_ring``: a ``LocalRing`` on
  the orders' device, or under a process group this rank's blocks of a
  ``GroupRing``): each block exchanges its boundary planes and runs the
  fused kernel's halo entry on its own vertices.

On the CPU the two kernel backends run the plain version (see
``kernels.lower_star``).  Sandwich back-ends: ``torch``, the tensor port
of the reference's batched ``jax`` back-end (``kernels.sandwich``), and
``np``, the reference's sequential host oracles (dense lexsort
extraction, Union-Find over dicts, per-triangle set-XOR D1).  The ``np``
back-ends hand back the same tensor dataclasses on the pipeline's device;
nothing falls back to them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import gradient as GR
from repro_torch.core.critical import extract_critical
from repro_torch.core.extremum_graph import build_dual_graph
from repro_torch.core.gradient import GradientField
from repro_torch.core.grid import Grid
from repro_torch.core.pairing import pair_extrema_saddles
from repro_torch.core.saddle_saddle import pair_saddle_saddle_seq
from repro_torch.kernels import ops
from repro_torch.kernels.sandwich import (build_dual_graph_chase,
                                          extract_critical_kernel,
                                          pair_extrema_saddles_kernel,
                                          pair_saddle_saddle_wavefront)


class UnknownBackendError(KeyError):
    """Raised for a backend name absent from the registry."""


class UnknownSandwichBackendError(KeyError):
    """Raised for a sandwich back-end name absent from the registry."""


@dataclass(frozen=True)
class BackendCaps:
    """What a gradient backend offers beyond whole-grid rows."""

    streamed: bool = False   # kernel takes per-chunk halo key volumes
    sharded: bool = False    # rows per z-slab block (takes n_blocks=)


@dataclass(frozen=True)
class Backend:
    """One gradient front-end behind the common protocol."""

    name: str
    rows: Callable[[Grid, torch.Tensor], tuple]   # (grid, orders (B, nv))
    description: str = ""
    caps: BackendCaps = field(default_factory=BackendCaps)

    def rows_for(self, grid: Grid, orders: torch.Tensor,
                 n_blocks: int = 1) -> tuple:
        """``rows``, with the block count for a sharded backend."""
        if self.caps.sharded:
            return self.rows(grid, orders, n_blocks=n_blocks)
        return self.rows(grid, orders)

    def gradient(self, grid: Grid, order: torch.Tensor,
                 n_blocks: int = 1) -> GradientField:
        [gf] = GR.scatter_results_batch(
            grid, *self.rows_for(grid, order[None], n_blocks))
        return gf


@dataclass(frozen=True)
class SandwichBackend:
    """One implementation of the sandwich back-end phases."""

    name: str
    extract: Callable      # (grid, gf, order)          -> CriticalInfo
    pair_d0: Callable      # (ExtremumGraph)            -> ExtremaPairs
    build_dual: Callable   # (grid, gf, ci, saddles)    -> ExtremumGraph
    pair_d1: Callable      # (grid, gf, ci, c1, c2)     -> SaddleSaddlePairs
    description: str = ""


_REGISTRY: Dict[str, Backend] = {}
_SANDWICH_REGISTRY: Dict[str, SandwichBackend] = {}


def register_backend(backend: Backend, overwrite: bool = False) -> Backend:
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown backend {name!r}; registered backends: "
            f"{sorted(_REGISTRY)}") from None


def available_backends() -> Dict[str, Backend]:
    return dict(_REGISTRY)


def register_sandwich_backend(backend: SandwichBackend,
                              overwrite: bool = False) -> SandwichBackend:
    if backend.name in _SANDWICH_REGISTRY and not overwrite:
        raise ValueError(
            f"sandwich backend {backend.name!r} already registered")
    _SANDWICH_REGISTRY[backend.name] = backend
    return backend


def get_sandwich_backend(name: str) -> SandwichBackend:
    try:
        return _SANDWICH_REGISTRY[name]
    except KeyError:
        raise UnknownSandwichBackendError(
            f"unknown sandwich backend {name!r}; registered: "
            f"{sorted(_SANDWICH_REGISTRY)}") from None


def available_sandwich_backends() -> Dict[str, SandwichBackend]:
    return dict(_SANDWICH_REGISTRY)


def _rows(kernel: str) -> Callable:
    def rows(grid: Grid, orders: torch.Tensor):
        return ops.rows_batch(grid, orders, kernel)
    return rows


def _rows_np(grid: Grid, orders: torch.Tensor):
    """Rows of each field by literal Robins on the host
    (:func:`~repro_torch.core.gradient.lower_star_rows_np`), moved to the
    orders' device."""
    per = [GR.lower_star_rows_np(grid, o) for o in
           orders.reshape(-1, grid.nv).cpu().numpy()]
    return tuple(torch.from_numpy(np.concatenate(p)).to(orders.device)
                 for p in zip(*per))


def _rows_shardmap(grid: Grid, orders: torch.Tensor, n_blocks: int = 1):
    """Rows of each field from ``halo_gradient`` over ``block_ring(
    n_blocks, orders.device)`` (dense vertex orders: the fused kernel's
    int32 halo entry).  Under a process group each rank runs its own
    blocks' slabs of the order, and ``gather_blocks`` hands every rank all
    the rows, so the rest of the pipeline runs on every rank as the
    reference runs it on its one host: 153 B per vertex per rank (2.57 GB
    at 256^3) beside the rank's own blocks' rows."""
    from repro_torch.distributed import FrontConfig, block_ring
    from repro_torch.distributed.shardmap_pipeline import halo_gradient
    cfg = FrontConfig(grid.dims, n_blocks)
    cfg.nz_local                      # eager divisibility check
    ring = block_ring(n_blocks, orders.device)
    mine = ring.blocks()
    out = []
    for o in orders.reshape(-1, grid.nv):
        _, rows = halo_gradient(cfg, ring,
                                o.long().reshape(n_blocks, -1)[mine])
        out.append(tuple(ring.gather_blocks(r).flatten(0, 1) for r in rows))
    return tuple(torch.cat(p) for p in zip(*out))


register_backend(Backend(
    name="np", rows=_rows_np,
    description="literal Robins ProcessLowerStars on the host (heapq "
                "reference)"))
register_backend(Backend(
    name="fused", rows=_rows("fused"), caps=BackendCaps(streamed=True),
    description="fused gather + pairing CUDA kernel (csrc/fused.cu)"))
register_backend(Backend(
    name="prepass", rows=_rows("prepass"), caps=BackendCaps(streamed=True),
    description="(nv, 27) gather + prepass CUDA kernel (csrc/prepass.cu)"))
register_backend(Backend(
    name="torch", rows=_rows("torch"), caps=BackendCaps(streamed=True),
    description="(nv, 27) gather + plain PyTorch pairing"))
register_backend(Backend(
    name="shardmap", rows=_rows_shardmap, caps=BackendCaps(sharded=True),
    description="z-slab blocks with a boundary-plane halo exchange, the "
                "fused kernel's halo entry per block"))

register_sandwich_backend(SandwichBackend(
    name="np", extract=extract_critical, pair_d0=pair_extrema_saddles,
    build_dual=build_dual_graph, pair_d1=pair_saddle_saddle_seq,
    description="sequential reference back-end on the host (dense lexsort, "
                "Union-Find dicts, per-triangle set-XOR); the oracle"))
register_sandwich_backend(SandwichBackend(
    name="torch", extract=extract_critical_kernel,
    pair_d0=pair_extrema_saddles_kernel, build_dual=build_dual_graph_chase,
    pair_d1=pair_saddle_saddle_wavefront,
    description="batched tensor back-end: pointer-jumping D0, "
                "chase-resolved dual graph, wavefront D1 columns"))
