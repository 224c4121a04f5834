"""Resolved execution plans and the offset-table cache.

PyTorch counterpart of ``repro.pipeline.plan``.
``PersistencePipeline.lower(request)`` resolves a request into a
:class:`Plan`: backend, sandwich back-end, device, in-memory or streamed
execution (chunking, shards) and the exact stage chain (stages whose
outputs the request does not ask for are dropped).
Plans are frozen, hashable and inspectable (``describe()``).

PyTorch runs eagerly, so there is no compiled program to bind; the only
per-plan artifact is the row -> sid offset table set of the scatter,
cached per ``(dims, device)`` in a :class:`PlanCache`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.core.gradient import row_sid_offsets
from repro_torch.core.grid import Grid


class PlanCache:
    """Thread-safe LRU cache of per-plan artifacts (offset tables)."""

    def __init__(self, maxsize: int = 128):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.Lock()

    def get_or_build(self, key: tuple, builder: Callable[[], object]):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
            out = self._entries[key] = builder()
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            return out


@dataclass(frozen=True)
class Plan:
    """Resolved execution plan: everything decided, nothing run."""

    dims: Tuple[int, int, int]            # grid vertex dims (nx, ny, nz)
    backend: str                          # gradient registry name
    sandwich_backend: str                 # sandwich registry name
    device: str                           # torch device string
    homology_dims: Tuple[int, ...] = ()
    stage_names: Tuple[str, ...] = ()
    streamed: bool = False
    chunk_z: Optional[int] = None
    chunk_budget: Optional[int] = None
    n_blocks: int = 1                     # z-slab shards (streamed only)

    @property
    def key(self) -> tuple:
        return (self.dims, self.backend, self.sandwich_backend, self.device,
                self.homology_dims, self.streamed, self.chunk_z,
                self.chunk_budget, self.n_blocks)

    @property
    def grid(self) -> Grid:
        return Grid.of(*self.dims)

    def describe(self) -> str:
        """Human-readable one-plan summary."""
        if self.streamed and self.n_blocks > 1:
            # the composed engine: every shard streams its z-slab, the
            # boundary-plane halo exchange is double-buffered against
            # chunk compute
            mode = (f"sharded-streamed x{self.n_blocks} "
                    f"(overlapped halo exchange)")
        elif self.streamed:
            mode = "streamed"
        else:
            mode = "in-memory"
        return (f"Plan(dims={self.dims}, backend={self.backend!r}, "
                f"{mode} on {self.device}, sequential back-end, "
                f"sandwich={self.sandwich_backend!r}, "
                f"n_blocks={self.n_blocks}, "
                f"homology_dims={self.homology_dims}, "
                f"stages={' -> '.join(self.stage_names)})")

    def row_offsets(self, cache: PlanCache):
        """The scatter's row -> sid offset tables on the plan's device."""
        return cache.get_or_build(
            ("row_offsets", self.dims, self.device),
            lambda: row_sid_offsets(self.grid, self.device))
