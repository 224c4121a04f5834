"""Request-batching persistence-diagram service over the pipeline.

PyTorch counterpart of ``repro.serve.topo_service``.  ``TopoService``
takes concurrent requests — numpy arrays, torch tensors, out-of-core
:class:`~repro_torch.stream.FieldSource`s or full :class:`TopoRequest`
specs — coalesces compatible ones into shape-homogeneous batches and
answers each batch with ONE ``PersistencePipeline.run_batch`` dispatch
(one lower-star kernel launch over the stacked batch) on the pipeline's
device.  A single worker thread drains the queue; callers get
``concurrent.futures.Future``s.

    with TopoService(max_batch=8) as svc:          # on the card
        futs = [svc.submit(f) for f in fields]
        results = [ft.result(timeout=60) for ft in futs]

``wire=True`` resolves futures to DDMS v1 payloads.  ``cache=`` fronts
the epsilon-aware :class:`~repro_torch.cache.DiagramCache` (probed
before batching, filled after delivery, tightened by progressive
refinements); ``admission=`` degrades deadline-less exact requests to
bounded-error ones under queue pressure and sheds past the hard
threshold with :class:`~repro_torch.cache.ServiceOverloadedError`.
Progressive submits (``progressive=True`` / ``deadline_s=``) get a
:class:`ProgressiveFuture` whose ``preview`` resolves on the coarsest
result.  A request that fails fails only its own future: a failed batch
is re-served request by request, and the worker survives any exception.
Close the service (``close()`` or ``with``) to stop its thread.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.cache import (AdmissionPolicy, CacheKeyError, DiagramCache,
                               degrade_request)
from repro_torch.cache.admission import DEGRADE, SHED
from repro_torch.core.grid import Grid
from repro_torch.obs import flight as _flight
from repro_torch.obs import watchdog as _watchdog
from repro_torch.obs.exposition import serve_metrics
from repro_torch.obs.metrics import MetricsRegistry, global_metrics
from repro_torch.pipeline import (DiagramResult, PersistencePipeline,
                                  TopoRequest)


@dataclass
class ServiceStats:
    """Aggregate serving counters (inspectable while running).

    Also *callable*: ``svc.stats()`` returns a fresh snapshot dict —
    the counters plus the service's metric instruments (queue depth,
    batch-size and request-latency histograms with p50/p95/p99).  The
    snapshot is a copy: mutating it never touches live service state,
    and live updates never surprise a caller holding one."""

    requests: int = 0
    batches: int = 0
    batched_requests: int = 0        # requests answered in a batch of > 1
    max_batch: int = 0
    errors: int = 0
    retried: int = 0                 # re-served alone after a batch failure
    stream_requests: int = 0         # FieldSource requests (out-of-core)
    progressive_requests: int = 0    # preview-then-refine submits
    traced_requests: int = 0         # requests that carried trace=True
    cache_hits: int = 0              # answered from the diagram cache
    cache_misses: int = 0            # probed the cache, had to compute
    degraded: int = 0                # rewritten to bounded-error on submit
    shed: int = 0                    # rejected with ServiceOverloadedError
    metrics: Optional[MetricsRegistry] = field(
        default=None, repr=False, compare=False)
    cache: Optional[DiagramCache] = field(
        default=None, repr=False, compare=False)

    def as_dict(self) -> Dict[str, int]:
        return dict(requests=self.requests, batches=self.batches,
                    batched_requests=self.batched_requests,
                    max_batch=self.max_batch, errors=self.errors,
                    retried=self.retried,
                    stream_requests=self.stream_requests,
                    progressive_requests=self.progressive_requests,
                    traced_requests=self.traced_requests,
                    cache_hits=self.cache_hits,
                    cache_misses=self.cache_misses,
                    degraded=self.degraded, shed=self.shed)

    def snapshot(self) -> Dict[str, object]:
        """Counters + metric summaries, as freshly-built plain dicts."""
        out: Dict[str, object] = dict(self.as_dict())
        if self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def __call__(self) -> Dict[str, object]:
        return self.snapshot()


class ProgressiveFuture(Future):
    """The future of a progressive submit: resolves to the **final**
    (tightest-bound) result; ``preview`` resolves to the first, coarsest
    result as soon as the refinement walk produces it (typically
    orders of magnitude earlier), and ``partials`` collects every
    intermediate delivered so far (in refinement order, bounds
    non-increasing).  With ``wire=True`` all of them hold serialized
    payloads instead of live results."""

    def __init__(self):
        super().__init__()
        self.preview: Future = Future()
        self.partials: List = []


def _as_request(f, grid: Optional[Grid]) -> "tuple[TopoRequest, bool]":
    """Coerce a submit payload to (TopoRequest, is_plain_field)."""
    if isinstance(f, TopoRequest):
        if grid is not None:
            f = f.replace(grid=grid)
        return f, False
    if isinstance(f, torch.Tensor):
        return TopoRequest(field=f, grid=grid), True
    if isinstance(f, np.ndarray) or np.isscalar(f) \
            or isinstance(f, (list, tuple)):
        return TopoRequest(field=np.asarray(f), grid=grid), True
    return TopoRequest(field=f, grid=grid), False  # FieldSource


@dataclass
class _Request:
    req: TopoRequest
    plain: bool                      # bare array or tensor, default options
    future: Future = field(default_factory=Future)
    submitted: float = field(default_factory=time.perf_counter)
    degraded: bool = False           # admission rewrote it to bounded-error
    key: Optional[tuple] = None      # cache key (set by the worker probe)

    def __post_init__(self):
        if self.progressive and not isinstance(self.future,
                                               ProgressiveFuture):
            self.future = ProgressiveFuture()

    @property
    def progressive(self) -> bool:
        """Multi-result serving: a preview future resolves first."""
        return self.req.progressive or self.req.deadline_s is not None

    @property
    def group_key(self):
        """Batching key: streams and progressive refinements serve
        alone; plain ndarrays group by (shape, grid); option-carrying
        requests also group by their execution options so one
        ``run_batch`` sees one plan."""
        r = self.req
        dims = r.grid.dims if r.grid is not None else None
        if self.progressive:
            return ("progressive", id(self))
        if r.is_stream:
            return ("stream", r.field_shape)
        if self.plain:
            return ("plain", r.field_shape, dims)
        # result-only options (min_persistence / top_k / include_report)
        # stay per-request through run_batch, so they must NOT split
        # batches — only plan-affecting options key the group
        opts = (r.homology_dims, r.backend, r.n_blocks, r.distributed,
                r.anticipation, r.budget, r.epsilon, r.trace)
        return ("req", r.field_shape, dims, opts)


class TopoService:
    """Batched diagram serving on top of a :class:`PersistencePipeline`.

    Parameters
    ----------
    pipeline : an existing pipeline, or None to build one from
        ``pipeline_kw`` (e.g. ``device="cpu"``; the default runs on the
        card).
    max_batch : max requests coalesced into one batched dispatch.
    max_wait_s : how long the worker waits to grow a batch once it holds
        at least one request (latency/throughput knob).
    wire : resolve futures to serialized wire payloads (bytes) instead
        of live :class:`DiagramResult` objects.
    cache : the epsilon-aware diagram cache (``repro_torch.cache``): a
        :class:`DiagramCache` instance, ``True`` for a default-budget
        one, or None (default) to serve uncached.  Cache hits resolve
        to *decoded wire payloads* (bit-exact arrays/queries, no live
        ``Diagram`` object and no ``report``) — or to the raw payload
        bytes under ``wire=True``.
    admission : an :class:`~repro_torch.cache.AdmissionPolicy` applied at
        submit time (degrade deadline-less requests under pressure,
        shed past the hard threshold), or None (default) to admit
        everything.
    metrics_port : when not None, start an embedded Prometheus scrape
        endpoint (``repro_torch.obs.exposition``) exposing the service's
        private registry plus the process-global one; ``0`` binds a
        free port — read ``svc.metrics_server.url``.  Closed with the
        service.
    """

    def __init__(self, pipeline: Optional[PersistencePipeline] = None, *,
                 max_batch: int = 8, max_wait_s: float = 0.002,
                 wire: bool = False,
                 cache: Union[DiagramCache, bool, None] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 metrics_port: Optional[int] = None,
                 **pipeline_kw):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.pipeline = pipeline or PersistencePipeline(**pipeline_kw)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.wire = wire
        if cache is True:
            cache = DiagramCache()
        elif cache is False:
            cache = None
        self.cache: Optional[DiagramCache] = cache
        self.admission = admission
        # a private registry, not the process-global one: the service's
        # queue/batch/latency telemetry lives and dies with it
        self._metrics = MetricsRegistry()
        # queue_depth counts submitted-not-yet-collected requests via
        # inc/dec under the submit lock + in the worker: a set(qsize())
        # outside the lock could run after the worker drained and leave
        # the gauge stale/backwards
        # canonical dotted names, with the pre-exposition flat names as
        # aliases of the SAME instruments (snapshot()/stats() show both)
        self._m_depth = self._metrics.gauge("service.queue_depth",
                                            alias="queue_depth")
        self._m_batch = self._metrics.histogram("service.batch_size",
                                                alias="batch_size", lo=1.0,
                                                hi=4096.0, factor=2.0)
        self._m_latency = self._metrics.histogram(
            "service.request_latency_s", alias="request_latency_s")
        self._m_hits = self._metrics.counter("service.cache.hits",
                                             alias="cache.hits")
        self._m_misses = self._metrics.counter("service.cache.misses",
                                               alias="cache.misses")
        self._m_degraded = self._metrics.counter(
            "service.admission.degraded", alias="admission.degraded")
        self._m_shed = self._metrics.counter("service.admission.shed",
                                             alias="admission.shed")
        self.stats = ServiceStats(metrics=self._metrics, cache=cache)
        self.metrics_server = None
        if metrics_port is not None:
            self.metrics_server = serve_metrics(
                [self._metrics, global_metrics()], port=metrics_port)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()  # orders submits vs the close sentinel
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="topo-service")
        self._worker.start()

    # -- client API --------------------------------------------------------

    def submit(self, f, grid: Optional[Grid] = None) -> Future:
        """Enqueue one request; the Future resolves to a
        :class:`DiagramResult` (or wire bytes when ``wire=True``).

        ``f`` may be an ndarray or tensor, a
        :class:`repro_torch.stream.FieldSource`
        (answered out-of-core via the streamed path), or a full
        :class:`TopoRequest` carrying its own options.  Progressive
        requests (``progressive=True`` / ``deadline_s=``) get a
        :class:`ProgressiveFuture`: its ``preview`` resolves to the
        coarse first answer while refinement continues.

        With an admission policy, a submit under queue pressure may be
        *degraded* (rewritten to a bounded-error request — the result
        carries its ``error_bound``) or *shed*: raises
        :class:`~repro_torch.cache.ServiceOverloadedError` with a
        ``retry_after_s`` hint instead of queueing unserviceable
        work."""
        req, plain = _as_request(f, grid)
        r = _Request(req, plain)
        with self._lock:
            if self._closed:
                raise RuntimeError("TopoService is closed")
            if self.admission is not None:
                r = self._admit(r)      # may raise ServiceOverloadedError
            self._queue.put(r)
            self._m_depth.inc()
        return r.future

    def _admit(self, r: _Request) -> _Request:
        """Apply the admission policy to one submit (under the lock)."""
        depth = int(self._m_depth.value)
        decision = self.admission.decide(
            depth, p99_latency_s=self._m_latency.percentile(0.99))
        if decision == SHED:
            self.stats.shed += 1
            self._m_shed.inc()
            raise self.admission.overload_error(depth)
        if decision == DEGRADE:
            req, did = degrade_request(r.req, self.admission)
            if did:
                # the rewritten request carries epsilon: it must group
                # as an option-carrying request, never as a plain field
                self.stats.degraded += 1
                self._m_degraded.inc()
                return _Request(req, plain=False, future=r.future,
                                submitted=r.submitted, degraded=True)
        return r

    def diagram(self, f, grid: Optional[Grid] = None) -> DiagramResult:
        """Synchronous single request."""
        return self.submit(f, grid).result()

    def map(self, fields: Sequence,
            grid: Union[Grid, Sequence[Optional[Grid]], None] = None
            ) -> List[DiagramResult]:
        """Submit a burst of requests, gather results in order.

        ``fields`` may mix arrays, tensors, ``FieldSource``s, and
        ``TopoRequest``s; ``grid`` is either one shared :class:`Grid`
        or a per-request sequence (None entries infer/defer)."""
        fields = list(fields)           # generators are welcome
        if isinstance(grid, (list, tuple)):
            if len(grid) != len(fields):
                raise ValueError(
                    f"per-request grids: got {len(grid)} grids for "
                    f"{len(fields)} fields")
            grids: Sequence[Optional[Grid]] = grid
        else:
            grids = [grid] * len(fields)
        futs = [self.submit(f, g) for f, g in zip(fields, grids)]
        return [ft.result() for ft in futs]

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # under the lock: nothing lands after it
        self._worker.join()
        if self.metrics_server is not None:
            self.metrics_server.close()

    def __enter__(self) -> "TopoService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker ------------------------------------------------------------

    def _collect(self) -> List[Optional[_Request]]:
        """Block for one request, then grow the batch until ``max_wait_s``
        has elapsed since the first arrival (or the batch is full).

        The depth gauge is decremented here per collected request (the
        close sentinel is never counted), pairing the increment done
        under the submit lock — the gauge tracks submitted-not-yet-
        collected requests exactly, instead of sampling ``qsize()``
        after the fact (which could observe a queue the worker already
        drained and go stale/backwards)."""
        first = self._queue.get()
        batch = [first]
        if first is None:
            return batch
        self._m_depth.dec()
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(nxt)
            if nxt is None:
                break
            self._m_depth.dec()
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            stop = batch[-1] is None
            reqs = [r for r in batch if r is not None]
            if reqs:
                try:
                    # armed only while a batch is actually being served:
                    # an idle service is quiet by design, not stalled
                    with _watchdog.lane("service.worker",
                                        metrics=self._metrics):
                        self._serve(reqs)
                except BaseException as e:  # the worker must outlive ANY
                    # request failure: fail whatever is still unresolved
                    # and keep draining the queue
                    _flight.crash_dump(
                        f"service.worker:{type(e).__name__}", exc=e)
                    for r in reqs:
                        if self._fail_request(r, e):
                            self.stats.errors += 1
            if stop:
                return

    def _payload(self, res: DiagramResult):
        if self.wire:
            from .engine import topo_payload
            return topo_payload(res)
        return res

    def _deliver(self, r: _Request, res: DiagramResult) -> None:
        self._m_latency.observe(time.perf_counter() - r.submitted)
        _resolve(r.future, self._payload(res))

    # -- cache plumbing ----------------------------------------------------

    def _probe_key(self, r: _Request) -> Optional[tuple]:
        """The cache key of a request, or None when it is uncacheable
        (no cache, opted out, traced, progressive, or the field has no
        fingerprint).  ``cache=True`` requests *require* a key: a
        :class:`CacheKeyError` fails their future instead of silently
        recomputing every time."""
        if self.cache is None or r.req.cache is False:
            return None
        if r.req.trace:
            return None   # a trace wants this run's timeline
        try:
            return r.req.cache_key()
        except CacheKeyError:
            if r.req.cache is True:
                raise
            return None

    def _try_cache(self, r: _Request) -> bool:
        """Probe the cache for one request; True when it was served.

        Sets ``r.key`` either way so the compute path stores the result
        under the same canonical key it was probed with.  An exact
        request (no epsilon) is served only by exact entries; an
        epsilon request by any entry at least that tight."""
        try:
            r.key = self._probe_key(r)
        except CacheKeyError as e:
            self.stats.errors += 1
            self._fail_request(r, e)
            return True                  # consumed (failed), not computed
        if r.key is None:
            return False
        if r.progressive:
            # progressive submits are the refinement path that
            # *populates* the cache: never served from it, but the key
            # stays set so every refinement stores/upgrades its entry
            return False
        eps = r.req.epsilon if r.req.epsilon is not None else 0.0
        ent = self.cache.get(r.key, epsilon=eps)
        if ent is None:
            self.stats.cache_misses += 1
            self._m_misses.inc()
            return False
        self.stats.cache_hits += 1
        self._m_hits.inc()
        self._m_latency.observe(time.perf_counter() - r.submitted)
        payload = ent.payload if self.wire \
            else DiagramResult.from_bytes(ent.payload)
        _resolve(r.future, payload)
        return True

    def _store(self, r: _Request, res: DiagramResult) -> None:
        """Admit a freshly computed result (after delivery, so storing
        never adds to the client-visible latency).  Exact results store
        with bound 0.0; approximate ones with their stamped guarantee —
        a tighter payload upgrades the entry in place."""
        if r.key is None or self.cache is None:
            return
        try:
            bound = res.error_bound
            self.cache.put(r.key, res.to_bytes(),
                           error_bound=0.0 if bound is None else bound,
                           level=res.approx_level or 0)
        except Exception:
            pass   # a cache-admission failure must never fail serving

    @staticmethod
    def _fail_request(r: _Request, e: BaseException) -> bool:
        failed = _fail(r.future, e)
        if isinstance(r.future, ProgressiveFuture):
            _fail(r.future.preview, e)
        return failed

    def _serve_one(self, r: _Request) -> None:
        """Answer a single request through the one resolver."""
        _watchdog.progress("service.worker")
        try:
            res = self.pipeline.run(r.req)
        except Exception as e:
            self.stats.errors += 1
            self._fail_request(r, e)
        else:
            self._deliver(r, res)
            self._store(r, res)

    def _serve_progressive(self, r: _Request) -> None:
        """Preview-then-refine: walk the refinement generator, resolving
        the preview future on the first (coarsest) result, collecting
        intermediates, and resolving the main future with the final
        one.  One failed refinement fails only this request.  Each
        refinement is stored as it lands, so a cache entry under this
        key monotonically tightens while the client watches."""
        from repro_torch.approx import refine
        try:
            last = None
            for res in refine(self.pipeline, r.req):
                _watchdog.progress("service.worker")
                last = self._payload(res)
                r.future.partials.append(last)
                _resolve(r.future.preview, last)
                self._store(r, res)
            if last is None:
                raise RuntimeError("refinement produced no result")
        except Exception as e:
            self.stats.errors += 1
            self._fail_request(r, e)
        else:
            _resolve(r.future, last)

    def _serve_batched(self, group: List[_Request]) -> List[DiagramResult]:
        """One batched dispatch for a compatible group."""
        return self.pipeline.run_batch([r.req for r in group])

    def _serve(self, reqs: List[_Request]) -> None:
        self.stats.requests += len(reqs)
        self.stats.traced_requests += sum(1 for r in reqs if r.req.trace)
        if self.cache is not None:
            # probe before grouping: a hit never occupies a batch slot,
            # and a mixed batch is never split by cacheability
            reqs = [r for r in reqs if not self._try_cache(r)]
            if not reqs:
                return
        # group compatible runs so one dispatch sees one plan + shape
        groups: Dict[object, List[_Request]] = {}
        for r in reqs:
            groups.setdefault(r.group_key, []).append(r)
        for group in groups.values():
            _watchdog.progress("service.worker")
            self.stats.batches += 1
            if group[0].progressive:
                self.stats.progressive_requests += len(group)
                for r in group:
                    self._serve_progressive(r)
                continue
            if group[0].req.is_stream:
                # streams are served one by one (no batching to report)
                self.stats.stream_requests += len(group)
                for r in group:
                    self._serve_one(r)
                continue
            self.stats.max_batch = max(self.stats.max_batch, len(group))
            self._m_batch.observe(len(group))
            if len(group) > 1:
                self.stats.batched_requests += len(group)
            try:
                results = self._serve_batched(group)
            except Exception:
                # a failed batch is re-served request-by-request so one
                # poisoned field fails only its own future; siblings in
                # the batch still get answers
                self.stats.retried += len(group)
                for r in group:
                    self._serve_one(r)
                continue
            for r, res in zip(group, results):
                self._deliver(r, res)
                self._store(r, res)


def _resolve(future: Future, result) -> None:
    """set_result that tolerates cancelled or already-settled futures."""
    if future.done():
        return
    try:
        if future.set_running_or_notify_cancel():
            future.set_result(result)
    except (RuntimeError, InvalidStateError):
        pass  # settled concurrently; never let delivery kill the worker


def _fail(future: Future, exc: BaseException) -> bool:
    """set_exception unless the future is already done/cancelled."""
    if future.done():
        return False
    try:
        if future.set_running_or_notify_cancel():
            future.set_exception(exc)
            return True
    except (RuntimeError, InvalidStateError):
        pass
    return False
