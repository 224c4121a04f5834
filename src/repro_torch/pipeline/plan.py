"""Resolved execution plans and the offset-table cache.

PyTorch counterpart of ``repro.pipeline.plan``.
``PersistencePipeline.lower(request)`` resolves a request into a
:class:`Plan`: backend, sandwich back-end, device, in-memory or streamed
execution (chunking, shards), the sequential or distributed back-end
(block count, D1 anticipation and budget) and the exact stage chain
(stages whose outputs the request does not ask for are dropped).
Plans are frozen, hashable and inspectable (``describe()``).

``Plan.compile()`` binds the plan into an :class:`Executable`: the
backend's rows program for the plan's grid and block count, and the
row -> sid offset tables of the scatter, cached per ``(dims, device)``
in a :class:`PlanCache`.  PyTorch runs eagerly, so binding a rows
program compiles nothing (the CUDA kernels are built once per process
at their first launch, ``kernels.build``) and it is not cached; the
offset tables are the only per-plan artifact.  Hits, misses and
evictions of every cache also count into the process-wide
``plan_cache.*`` counters of :func:`repro_torch.obs.global_metrics`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.gradient import row_sid_offsets
from repro_torch.core.grid import Grid
from repro_torch.obs.metrics import global_metrics

from .backends import Backend, get_backend

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

    def __bool__(self) -> bool:
        # a cache is truthy even when empty, so `cache or default` never
        # drops a fresh cache for the shared one
        return True

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def peek(self, key: tuple):
        """Read without building (KeyError if absent); no LRU touch."""
        with self._lock:
            return self._entries[key]

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

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
    n_blocks: int = 1                     # z-slab blocks / shards
    distributed: bool = False             # distributed back-end engines
    anticipation: bool = True             # token D1 knobs (distributed)
    budget: Optional[int] = None
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
                self.chunk_budget, self.n_blocks, self.distributed,
                self.anticipation, self.budget, self.epsilon,
                self.deadline_s, self.progressive)

    @property
    def is_approx(self) -> bool:
        """Whether execution routes through ``repro_torch.approx``."""
        return self.epsilon is not None or self.progressive \
            or self.deadline_s is not None

    @property
    def compile_key(self) -> tuple:
        """What a rows program depends on: (dims, backend, n_blocks),
        whatever the result options."""
        return (self.dims, self.backend, self.n_blocks)

    @property
    def result_key(self) -> tuple:
        """The plan facets that determine result *content*: grid dims and
        homology dims.  Backend, sandwich back-end, device, sharding,
        streaming and chunking give bit-identical diagrams, and epsilon
        is a lookup-time predicate, so none of them is part of it."""
        return (self.dims, self.homology_dims)

    @property
    def grid(self) -> Grid:
        return Grid.of(*self.dims)

    def describe(self) -> str:
        """Human-readable one-plan summary."""
        if self.streamed and self.n_blocks > 1:
            # the composed engine: every shard streams its z-slab on its
            # card, the boundary-plane halo exchange is double-buffered
            # against chunk compute
            from repro_torch.stream.sharded import _shard_devices
            cards = _shard_devices(torch.device(self.device))
            mode = (f"sharded-streamed x{self.n_blocks} over "
                    f"{', '.join(map(str, cards[:self.n_blocks]))} "
                    f"(overlapped halo exchange)")
        elif self.streamed:
            mode = "streamed"
        else:
            mode = "in-memory"
        engine = "distributed" if self.distributed else "sequential"
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
                f"{mode} on {self.device}, {engine} back-end, "
                f"sandwich={self.sandwich_backend!r}, "
                f"n_blocks={self.n_blocks}, "
                f"homology_dims={self.homology_dims}{approx}, "
                f"stages={' -> '.join(self.stage_names)})")

    def row_offsets(self, cache: PlanCache):
        """The scatter's row -> sid offset tables on the plan's device."""
        return cache.get_or_build(
            ("row_offsets", self.dims, self.device),
            lambda: row_sid_offsets(self.grid, self.device))

    def compile(self, cache: Optional[PlanCache] = None,
                backend: Optional[Backend] = None) -> "Executable":
        """Bind the rows program, and the offset tables through ``cache``
        (the shared default if None).  ``backend`` overrides the registry
        lookup (the pipeline passes the instance it holds)."""
        cache = cache or default_plan_cache()
        be = get_backend(self.backend) if backend is None else backend
        grid, n_blocks = self.grid, self.n_blocks
        return Executable(
            plan=self, backend=be,
            rows_program=lambda orders: be.rows_for(grid, orders, n_blocks),
            row_offsets=self.row_offsets(cache), cache=cache)


@dataclass(frozen=True)
class Executable:
    """A plan with its artifacts bound, ready to execute: ``rows_program``
    maps orders (B, nv) to the packed rows of the flattened batch,
    ``row_offsets`` are the scatter's row -> sid tables on the plan's
    device, out of the :class:`PlanCache`."""

    plan: Plan
    backend: Backend
    rows_program: Optional[Callable] = None
    row_offsets: object = None
    cache: PlanCache = field(default_factory=default_plan_cache, repr=False,
                             compare=False)
