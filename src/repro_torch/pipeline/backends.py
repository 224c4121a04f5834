"""Backend registries: gradient front-ends and sandwich back-ends.

PyTorch counterpart of ``repro.pipeline.backends``.

Gradient backends (a :class:`Backend` bundles ``rows(grid, orders (B, nv))
-> packed rows`` and derives ``gradient(grid, order) -> GradientField``;
its :class:`BackendCaps` say what else it offers — ``streamed``: a kernel
for one halo-extended z-slab, ``kernels.ops.lower_star_rows_halo``):

- ``fused``   — the fused CUDA lower-star kernel (default);
- ``prepass`` — the (nv, 27) gather + the prepass CUDA kernel;
- ``torch``   — the same gather + the plain PyTorch pairing.

On the CPU the two kernel backends run the plain version (see
``kernels.lower_star``).  Sandwich back-ends: ``torch``, the tensor port
of the reference's batched ``jax`` back-end (``kernels.sandwich``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from repro_torch.core import gradient as GR
from repro_torch.core.gradient import GradientField
from repro_torch.core.grid import Grid
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


@dataclass(frozen=True)
class Backend:
    """One gradient front-end behind the common protocol."""

    name: str
    rows: Callable[[Grid, torch.Tensor], tuple]   # (grid, orders (B, nv))
    description: str = ""
    caps: BackendCaps = field(default_factory=BackendCaps)

    def gradient(self, grid: Grid, order: torch.Tensor) -> GradientField:
        [gf] = GR.scatter_results_batch(grid, *self.rows(grid, order[None]))
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


register_backend(Backend(
    name="fused", rows=_rows("fused"), caps=BackendCaps(streamed=True),
    description="fused gather + pairing CUDA kernel (csrc/fused.cu)"))
register_backend(Backend(
    name="prepass", rows=_rows("prepass"), caps=BackendCaps(streamed=True),
    description="(nv, 27) gather + prepass CUDA kernel (csrc/prepass.cu)"))
register_backend(Backend(
    name="torch", rows=_rows("torch"), caps=BackendCaps(streamed=True),
    description="(nv, 27) gather + plain PyTorch pairing"))

register_sandwich_backend(SandwichBackend(
    name="torch", extract=extract_critical_kernel,
    pair_d0=pair_extrema_saddles_kernel, build_dual=build_dual_graph_chase,
    pair_d1=pair_saddle_saddle_wavefront,
    description="batched tensor back-end: pointer-jumping D0, "
                "chase-resolved dual graph, wavefront D1 columns"))
