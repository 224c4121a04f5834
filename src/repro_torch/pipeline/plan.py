"""Resolved execution plans and the offset-table cache.

PyTorch counterpart of ``repro.pipeline.plan``.
``PersistencePipeline.lower(request)`` resolves a request into a
:class:`Plan`: backend, sandwich back-end, device, in-memory or streamed
execution (chunking, shards) and the exact stage chain (stages whose
outputs the request does not ask for are dropped).
Plans are frozen, hashable and inspectable (``describe()``).

PyTorch runs eagerly, so there is no compiled program to bind; the only
per-plan artifact is the row -> sid offset table set of the scatter,
cached per ``(dims, device)`` in a :class:`PlanCache`.  Hits, misses and
evictions of every cache also count into the process-wide
``plan_cache.*`` counters of :func:`repro_torch.obs.global_metrics`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.gradient import row_sid_offsets
from repro_torch.core.grid import Grid
from repro_torch.obs.metrics import global_metrics

# process-wide counters, summed over every PlanCache
_M_HITS = global_metrics().counter("plan_cache.hits")
_M_MISSES = global_metrics().counter("plan_cache.misses")
_M_EVICTIONS = global_metrics().counter("plan_cache.evictions")


class PlanCache:
    """Thread-safe LRU cache of per-plan artifacts (offset tables)."""

    def __init__(self, maxsize: int = 128):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: tuple, builder: Callable[[], object]):
        with self._lock:
            if key in self._entries:
                self.hits += 1
                _M_HITS.inc()
                self._entries.move_to_end(key)
                return self._entries[key]
            self.misses += 1
            _M_MISSES.inc()
            out = self._entries[key] = builder()
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                _M_EVICTIONS.inc()
            return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(size=len(self._entries), hits=self.hits,
                        misses=self.misses, evictions=self.evictions)


_DEFAULT_CACHE = PlanCache()


def default_plan_cache() -> PlanCache:
    """The process-wide cache a pipeline uses when it is given none."""
    return _DEFAULT_CACHE


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
    # approximation knobs (repro_torch.approx): recorded so the resolver
    # routes to the hierarchy engine and batches never mix approximate
    # with exact execution
    epsilon: Optional[float] = None
    deadline_s: Optional[float] = None
    progressive: bool = False

    @property
    def key(self) -> tuple:
        return (self.dims, self.backend, self.sandwich_backend, self.device,
                self.homology_dims, self.streamed, self.chunk_z,
                self.chunk_budget, self.n_blocks, self.epsilon,
                self.deadline_s, self.progressive)

    @property
    def is_approx(self) -> bool:
        """Whether execution routes through ``repro_torch.approx``."""
        return self.epsilon is not None or self.progressive \
            or self.deadline_s is not None

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
        approx = ""
        if self.is_approx:
            knobs = [f"epsilon={self.epsilon}"] \
                if self.epsilon is not None else []
            if self.progressive:
                knobs.append("progressive")
            if self.deadline_s is not None:
                knobs.append(f"deadline_s={self.deadline_s}")
            approx = f", approx({', '.join(knobs)})"
        return (f"Plan(dims={self.dims}, backend={self.backend!r}, "
                f"{mode} on {self.device}, sequential back-end, "
                f"sandwich={self.sandwich_backend!r}, "
                f"n_blocks={self.n_blocks}, "
                f"homology_dims={self.homology_dims}{approx}, "
                f"stages={' -> '.join(self.stage_names)})")

    def row_offsets(self, cache: PlanCache):
        """The scatter's row -> sid offset tables on the plan's device."""
        return cache.get_or_build(
            ("row_offsets", self.dims, self.device),
            lambda: row_sid_offsets(self.grid, self.device))
