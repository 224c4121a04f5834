"""`PersistencePipeline` — one front door for persistence diagrams.

PyTorch counterpart of ``repro.pipeline.api``:

    from repro_torch.pipeline import PersistencePipeline, TopoRequest

    pipe = PersistencePipeline()                 # backend="fused", on cuda
    res  = pipe.run(TopoRequest(field=f, grid=g, top_k=50))
    ress = pipe.run_batch([TopoRequest(field=f) for f in fields])

``run`` and ``run_batch`` share one path: requests are resolved, lowered
to a :class:`Plan`, grouped by plan and field shape, and each group runs
the front-end (order, then ONE batched lower-star rows launch over the
(B, nv) stack, then the scatter) before the per-request back-end
(critical extraction, D0, dual, D1).  A single ``run`` is a group of one.

Approximate requests (``epsilon=`` / ``progressive=`` / ``deadline_s=``)
go through :mod:`repro_torch.approx` one by one: the coarsest hierarchy
level that meets ``epsilon``, or a coarse-to-fine walk, each level a
plain run of a decimated field.  ``trace=True`` runs the request under a
fresh :class:`~repro_torch.obs.trace.Trace` (``result.trace``).

Streamed requests (a :class:`~repro_torch.stream.FieldSource` field, or
``stream=True``; ``diagram_stream`` is the shim) take the out-of-core
path instead: the chunked front-end on rank-free (value, vid) keys
(``repro_torch.stream``; ``n_blocks > 1`` with ``distributed=False``
runs the sharded engine), the back-end on the dense key tensor as the
order, and exact ranks only for the vertices the diagram touches.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.diagram import Diagram
from repro_torch.core.gradient import scatter_results_batch
from repro_torch.obs.trace import Trace, current_trace, maybe_span, \
    trace_active

from .backends import (Backend, available_backends, get_backend,
                       get_sandwich_backend)
from .plan import Plan, PlanCache, default_plan_cache
from .request import TopoRequest, strip_field
from .result import DiagramResult
from .stages import (ALL_STAGES, FRONT_STAGES, PipelineState, StageReport,
                     _sync, run_stages)

_STAGES_BY_NAME = {st.name: st for st in ALL_STAGES}


def _back_stage_names(grid_dim: int, homology_dims) -> tuple:
    """The back-end stage chain for the requested dimensions: D0 always
    runs (its saddle set feeds the dual stage); the dual and D1 engines
    are dropped when no requested dimension needs their output."""
    dims = set(homology_dims)
    names = ["d0"]
    need_d1 = (grid_dim == 3 and bool(dims & {1, 2})) \
        or (grid_dim == 2 and 1 in dims)
    need_dual = (grid_dim >= 2 and bool(dims & {grid_dim - 1, grid_dim})) \
        or (grid_dim == 3 and need_d1) or grid_dim == 1
    if need_dual:
        names.append("d_top")
    if need_d1 or grid_dim <= 1:
        names.append("d1")
    return tuple(names)


class _Config:
    """What a stage reads: the gradient backend and the sandwich engine."""

    def __init__(self, backend: Backend, sandwich):
        self.backend = backend
        self.sandwich = sandwich


class PersistencePipeline:
    """Staged DMS executor on one torch device.

    backend : gradient registry name (``"fused"``, ``"prepass"``,
        ``"torch"``) or a :class:`Backend`; the default for requests that
        name none.
    sandwich_backend : sandwich registry name (``"torch"``).
    device : torch device; ``None`` means ``"cuda"``, which must be
        available (pass ``device="cpu"`` to run on the CPU, where the
        kernel backends use the plain PyTorch pairing).
    plan_cache : cache of the per-grid scatter offset tables (the
        process-wide :func:`default_plan_cache` if None).
    """

    def __init__(self, backend: Union[str, Backend] = "fused", *,
                 sandwich_backend: str = "torch", device=None,
                 plan_cache: Optional[PlanCache] = None):
        self.backend = backend if isinstance(backend, Backend) \
            else get_backend(backend)
        self.sandwich = get_sandwich_backend(sandwich_backend)
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PersistencePipeline runs on CUDA by default, and CUDA is "
                "not available; pass device='cpu' to run on the CPU")
        self.device = dev
        self.plan_cache = plan_cache if plan_cache is not None \
            else default_plan_cache()

    def _get_backend(self, name: str) -> Backend:
        return self.backend if name == self.backend.name else get_backend(name)

    @staticmethod
    def _as_request(request, grid=None, **options) -> TopoRequest:
        if isinstance(request, TopoRequest):
            if grid is not None or options:
                raise TypeError(
                    "pass options inside the TopoRequest, not alongside it")
            return request
        return TopoRequest(field=request, grid=grid, **options)

    # -- lower -----------------------------------------------------------

    def lower(self, request, grid=None, **options) -> Plan:
        """Resolve a request into an inspectable, hashable :class:`Plan`."""
        return self._lower_resolved(
            self._as_request(request, grid, **options).resolve())

    def _lower_resolved(self, req: TopoRequest) -> Plan:
        g = req.grid
        hdims = req.homology_dims if req.homology_dims is not None \
            else tuple(range(g.dim + 1))
        backend = req.backend if req.backend is not None \
            else self.backend.name
        be = self._get_backend(backend)
        sandwich = get_sandwich_backend(
            req.sandwich_backend or self.sandwich.name).name
        streamed = req.is_stream
        if streamed and not be.caps.streamed:
            ok = sorted(n for n, b in available_backends().items()
                        if b.caps.streamed)
            raise ValueError(
                f"backend {backend!r} has no streamed kernel; "
                f"streaming backends: {ok}")
        front = ("gradient", "extract_sort") if streamed \
            else tuple(st.name for st in FRONT_STAGES)
        return Plan(dims=g.dims, backend=backend, sandwich_backend=sandwich,
                    device=str(self.device), homology_dims=hdims,
                    stage_names=front + _back_stage_names(g.dim, hdims),
                    streamed=streamed, chunk_z=req.chunk_z,
                    chunk_budget=req.chunk_budget,
                    n_blocks=req.n_blocks or 1, epsilon=req.epsilon,
                    deadline_s=req.deadline_s, progressive=req.progressive)

    # -- run -------------------------------------------------------------

    def run(self, request: Union[TopoRequest, np.ndarray, torch.Tensor],
            grid=None, **options) -> DiagramResult:
        """Execute one request end to end."""
        req = self._as_request(request, grid, **options).resolve()
        if req.is_approx:
            return self._run_approx(req)
        plan = self._lower_resolved(req)
        if req.trace:
            # reports made under the activation bind to the trace; the
            # streaming workers take it from their stage report
            with trace_active(Trace()):
                return self._run_planned(req, plan)
        return self._run_planned(req, plan)

    def _run_planned(self, req: TopoRequest, plan: Plan) -> DiagramResult:
        if plan.streamed:
            return self._run_stream(req, plan)
        return self._run_group([req], plan)[0]

    def _run_approx(self, req: TopoRequest) -> DiagramResult:
        """Bounded-error path: the level that meets ``epsilon``, or the
        final result of a coarse-to-fine walk for progressive and
        deadline-carrying requests (``repro_torch.approx.refine`` yields
        the intermediates)."""
        from repro_torch.approx.engine import approximate
        from repro_torch.approx.progressive import approximate_progressive
        if req.progressive or req.deadline_s is not None:
            return approximate_progressive(self, req)
        return approximate(self, req)

    def run_batch(self, requests: Sequence) -> List[DiagramResult]:
        """Execute a batch: same-plan, same-shape requests share one
        batched front-end launch.  Results come back in submission order."""
        reqs = [self._as_request(r).resolve() for r in requests]
        plans = [self._lower_resolved(r) for r in reqs]
        groups: dict = {}
        for i, (req, plan) in enumerate(zip(reqs, plans)):
            groups.setdefault((plan.key, req.field_shape), []).append(i)
        out: List[Optional[DiagramResult]] = [None] * len(reqs)
        for idxs in groups.values():
            plan = plans[idxs[0]]
            if any(reqs[i].trace for i in idxs) or plan.is_approx:
                # a trace is per run, and approximation picks its level
                # per field: both serve one by one
                for i in idxs:
                    out[i] = self.run(reqs[i])
                continue
            if plan.streamed:
                for i in idxs:
                    out[i] = self._run_stream(reqs[i], plan)
                continue
            for i, res in zip(idxs, self._run_group([reqs[i] for i in idxs],
                                                    plan)):
                out[i] = res
        return out

    def _field(self, req: TopoRequest) -> torch.Tensor:
        f = req.field if isinstance(req.field, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(req.field))
        return f.to(self.device).reshape(-1)

    def _run_group(self, reqs: List[TopoRequest],
                   plan: Plan) -> List[DiagramResult]:
        """Batched front-end (one rows launch over the stacked batch), then
        per-request back-ends."""
        cfg = _Config(self._get_backend(plan.backend),
                      get_sandwich_backend(plan.sandwich_backend))
        grid = reqs[0].grid
        B = len(reqs)
        reports = [StageReport("pipeline") for _ in reqs]
        states = [PipelineState(grid, self._field(r)) for r in reqs]
        for state, report in zip(states, reports):
            run_stages(state, cfg, report, stages=(_STAGES_BY_NAME["order"],))

        t0 = time.perf_counter()
        with maybe_span(current_trace(), "gradient", batch_size=B):
            rows = cfg.backend.rows(grid,
                                    torch.stack([s.order for s in states]))
            gfs = scatter_results_batch(
                grid, *rows, B=B, offsets=plan.row_offsets(self.plan_cache))
            del rows
            _sync()
        dt = (time.perf_counter() - t0) / B
        for state, report, gf in zip(states, reports, gfs):
            rep = report.child("gradient")
            rep.seconds = dt
            n_crit = gf.n_critical()
            rep.count(n_critical=sum(n_crit.values()), batch_size=B,
                      **{f"n_critical_d{k}": v for k, v in n_crit.items()})
            state.gf = gf

        rest = tuple(_STAGES_BY_NAME[n] for n in ("extract_sort",)
                     + plan.stage_names[len(FRONT_STAGES):])
        out = []
        for req, state, report in zip(reqs, states, reports):
            run_stages(state, cfg, report, stages=rest)
            f = state.f
            out.append(self._finish(
                state.diagram(), report, req, plan,
                values_fn=(lambda vids, f=f: f[vids]) if f.numel() else None))
        return out

    @staticmethod
    def _finish(diagram, report: StageReport, req: TopoRequest, plan: Plan,
                values_fn=None, stream=None) -> DiagramResult:
        res = DiagramResult(
            diagram, report.flat(), report if req.include_report else None,
            stream=stream, request=strip_field(req), plan=plan,
            trace=report.trace, _values_fn=values_fn)
        # materialize the canonical query arrays now (tiny — critical
        # simplices only) so the result does not pin the field or the
        # dense key tensor for its lifetime
        res.arrays()
        res._values_fn = None
        return res

    def _source(self, req: TopoRequest):
        """The request's field as a FieldSource (arrays and tensors are
        wrapped in an ArraySource with the request's grid dims)."""
        from repro_torch.stream import as_source
        f = req.field
        if isinstance(f, torch.Tensor):
            f = f.detach().cpu().numpy()
        return as_source(f, dims=req.grid.dims)

    def _run_stream(self, req: TopoRequest, plan: Plan) -> DiagramResult:
        """Out-of-core path: chunked front-end on rank-free keys (the fused
        kernel's halo entry per chunk), back-end on the dense key tensor as
        the order, SparseOrder rank recovery.  ``n_blocks > 1`` selects the
        sharded streaming engine; output stays bit-identical."""
        from repro_torch.stream import (SparseOrder, diagram_vertices,
                                        sharded_stream_front, stream_front)
        cfg = _Config(self._get_backend(plan.backend),
                      get_sandwich_backend(plan.sandwich_backend))
        src = self._source(req)
        grid = req.grid
        chunk_z, chunk_budget = plan.chunk_z, plan.chunk_budget
        if chunk_z is None and chunk_budget is None:
            chunk_budget = 64 << 20
        report = StageReport("pipeline")

        with report.stage("gradient") as rep:
            if plan.n_blocks > 1:
                out = sharded_stream_front(
                    src, plan.n_blocks, kernel=plan.backend,
                    chunk_z=chunk_z, chunk_budget=chunk_budget,
                    stage_report=rep, device=self.device)
            else:
                out = stream_front(src, kernel=plan.backend, chunk_z=chunk_z,
                                   chunk_budget=chunk_budget,
                                   stage_report=rep, device=self.device)
            n_crit = out.gf.n_critical()
            rep.count(n_critical=sum(n_crit.values()),
                      **{f"n_critical_d{k}": v for k, v in n_crit.items()})

        # the back-end compares orders, never their absolute values, so
        # the dense key tensor stands in for the vertex order verbatim
        state = PipelineState(grid, torch.zeros(0, device=self.device),
                              order=out.keys, gf=out.gf)
        run_stages(state, cfg, report,
                   stages=tuple(_STAGES_BY_NAME[n]
                                for n in plan.stage_names[1:]))

        # exact global ranks, but only for the vertices the diagram
        # touches (a counting pass per slab — still no global argsort)
        with report.stage("rank_translate"):
            order = SparseOrder.from_keys(
                out.keys, diagram_vertices(grid, state.pairs,
                                           state.essential))
        return self._finish(
            Diagram(grid, order, state.pairs, state.essential), report, req,
            plan, stream=out.report, values_fn=out.values_for_vids)

    def diagram_stream(self, source, *, chunk_z: Optional[int] = None,
                       chunk_budget: Optional[int] = None) -> DiagramResult:
        """Persistence diagram of a field served chunk by chunk (shim over
        ``run`` with ``stream=True``).

        ``source`` is a :class:`repro_torch.stream.FieldSource` (in-memory
        array, ``np.memmap`` file, or on-demand generator) — the field is
        never materialized as one array; at most ~2 chunks of field data
        are resident (``result.stream`` accounts for it).  Output is
        bit-identical to :meth:`run` on the same field."""
        return self.run(TopoRequest(field=source, stream=True,
                                    chunk_z=chunk_z,
                                    chunk_budget=chunk_budget))
