"""The DMS stage chain + structured stage reporting.

PyTorch counterpart of ``repro.pipeline.stages``.  The paper's pipeline
is a fixed chain (Sec. II-F / III):

    order -> gradient -> critical extraction -> D0 -> D_{d-1} -> D1

The front-end is the same for the sequential and the distributed
algorithm; the config selects the back-end engines (the sandwich
back-end, or the distributed pairing rounds and token D1).

Each link is a stage object operating on a shared :class:`PipelineState`
of device tensors.  Timings and counters land in a :class:`StageReport`;
on a CUDA device each stage ends with a synchronize, so its seconds are
the device work it queued, not the time to enqueue it.

The report is span-backed: a report made while a
:class:`~repro_torch.obs.trace.Trace` is active on the thread
(``TopoRequest(trace=True)``) binds to it, and every ``stage()`` records a
span of the same name that closes after the stage's synchronize, with the
stage counters as its attributes.  The stage is a scope of sub-spans
(``obs.trace.sub_span``): after its synchronize each sub-span name
becomes a child report with the device seconds of its sub-spans summed
(``gradient.scatter``, ``extract_sort.edge_keys``, ``d0.fixpoint``), and
each scope counter a counter ``<stage>_<counter>`` (``d0_host_syncs``).
Untraced stages go to the always-on flight recorder instead.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.obs import flight as _flight
from repro_torch.obs.trace import Trace, current_trace, sub_span

from repro_torch.core.critical import CriticalInfo
from repro_torch.core.diagram import Diagram
from repro_torch.core.dms import as_pairs
from repro_torch.core.extremum_graph import build_d0_graph
from repro_torch.core.gradient import GradientField
from repro_torch.core.grid import Grid, vertex_order


# the wall-time split: the front-end (order + gradient) and the sandwich
# back-end (critical extraction on); ``comm`` stages nest under the
# gradient stage of a sharded streamed run and carry the comm-hiding split
FRONT_STAGE_NAMES = ("order", "gradient")
BACK_STAGE_NAMES = ("extract_sort", "d0", "d_top", "d1")
COMM_STAGE_NAMES = ("comm",)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class StageReport:
    """Per-stage record: wall time, counters, nested children; ``trace``
    is the run's :class:`Trace` (the thread's active one at construction)
    or None."""

    name: str
    seconds: float = 0.0
    counters: Dict[str, float] = field(default_factory=dict)
    children: List["StageReport"] = field(default_factory=list)
    trace: Optional[Trace] = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.trace is None:
            self.trace = current_trace()

    def child(self, name: str) -> "StageReport":
        r = StageReport(name, trace=self.trace)
        self.children.append(r)
        return r

    @contextmanager
    def stage(self, name: str):
        """Open (and time, up to a device synchronize) a child stage, and
        its span when traced."""
        r = self.child(name)
        tr = self.trace
        if tr is None:
            t0 = time.perf_counter()
            try:
                yield r
            finally:
                _sync()
                dt = time.perf_counter() - t0
                r.seconds += dt
                _flight.record_event(name, t0, dt, r.counters or None)
            return
        with tr.span(name) as sp, tr.scope(name) as sc:
            t0 = time.perf_counter()
            try:
                yield r
            finally:
                _sync()
                r.seconds += time.perf_counter() - t0
                for k, s in sc.resolve().items():
                    r.child(k).seconds = s
                r.count(**{f"{name}_{k}": v for k, v in sc.counters.items()})
                sp.args.update(r.counters)

    def count(self, **counters) -> None:
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0) + v

    @property
    def total_seconds(self) -> float:
        return self.seconds if self.seconds else \
            sum(c.total_seconds for c in self.children)

    def _named_seconds(self, names) -> float:
        return sum(c.total_seconds for c in self.children
                   if c.name in names)

    @property
    def front_seconds(self) -> float:
        """Front-end wall time (order + gradient child stages)."""
        return self._named_seconds(FRONT_STAGE_NAMES)

    @property
    def back_seconds(self) -> float:
        """Sandwich back-end wall time (extract_sort + d0 + d_top + d1)."""
        return self._named_seconds(BACK_STAGE_NAMES)

    def _counter_sum(self, key: str) -> float:
        return float(self.counters.get(key, 0.0)) + \
            sum(c._counter_sum(key) for c in self.children)

    @property
    def comm_seconds(self) -> float:
        """Halo-exchange wall time of a sharded run: ``comm`` stages,
        summed recursively (comm nests under the gradient stage)."""
        return self._named_seconds(COMM_STAGE_NAMES) + \
            sum(c.comm_seconds for c in self.children
                if c.name not in COMM_STAGE_NAMES)

    @property
    def overlap_fraction(self) -> Optional[float]:
        """Fraction of halo-exchange time hidden behind compute
        (``comm_hidden_s / comm_total_s`` over all nested comm stages);
        ``None`` when the run had no communication."""
        total = self._counter_sum("comm_total_s")
        return self._counter_sum("comm_hidden_s") / total \
            if total > 0 else None

    def flat(self) -> Dict[str, float]:
        """Flat stats: stage names -> seconds (nested names dot-joined),
        all counters merged at top level."""
        out: Dict[str, float] = {}

        def visit(r: "StageReport", prefix: str) -> None:
            for c in r.children:
                out[prefix + c.name] = c.seconds
                visit(c, prefix + c.name + ".")
            out.update(r.counters)

        visit(self, "")
        return out

    def to_dict(self) -> dict:
        """Nested machine-readable form (JSON-serializable)."""
        out = {"name": self.name, "seconds": self.seconds,
               "counters": dict(self.counters),
               "children": [c.to_dict() for c in self.children]}
        if self.children:
            out["front_seconds"] = self.front_seconds
            out["back_seconds"] = self.back_seconds
            comm = self.comm_seconds
            if comm > 0:
                out["comm_seconds"] = comm
                out["overlap_fraction"] = self.overlap_fraction
        return out


# --------------------------------------------------------------------------
# Pipeline state
# --------------------------------------------------------------------------

@dataclass
class PipelineState:
    """Everything a stage may read or produce, threaded through the chain."""

    grid: Grid
    f: torch.Tensor
    order: Optional[torch.Tensor] = None
    gf: Optional[GradientField] = None
    ci: Optional[CriticalInfo] = None
    pairs: Dict[int, torch.Tensor] = field(default_factory=dict)
    essential: Dict[int, torch.Tensor] = field(default_factory=dict)
    # inter-stage sets: saddles consumed by D0 / the dual diagram
    d0_saddles: Optional[torch.Tensor] = None
    dual_saddles: Optional[torch.Tensor] = None
    dual_paired_saddles: Optional[torch.Tensor] = None

    def diagram(self) -> Diagram:
        return Diagram(self.grid, self.order, self.pairs, self.essential)


def _minus(a: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Elements of ``a`` not in ``b``, in ``a``'s order."""
    if b is None or len(b) == 0:
        return a
    return a[~torch.isin(a, b)]


def _sorted(a: torch.Tensor) -> torch.Tensor:
    return torch.sort(a.long()).values


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

class OrderStage:
    """Global injective vertex order (Array Preconditioning, Sec. III)."""

    name = "order"

    def run(self, state: PipelineState, cfg, rep: StageReport) -> None:
        state.f = state.f.reshape(-1)
        state.order = vertex_order(state.f)


class GradientStage:
    """Discrete gradient via the configured backend."""

    name = "gradient"

    def run(self, state: PipelineState, cfg, rep: StageReport) -> None:
        state.gf = cfg.backend.gradient(state.grid, state.order,
                                        n_blocks=cfg.n_blocks)
        n_crit = state.gf.n_critical()
        rep.count(n_critical=sum(n_crit.values()),
                  **{f"n_critical_d{k}": v for k, v in n_crit.items()})


def sandwich_of(cfg):
    """The config's sandwich back-end (the ``np`` reference when the config
    names none)."""
    sb = getattr(cfg, "sandwich", None)
    if sb is None:
        from .backends import get_sandwich_backend
        sb = get_sandwich_backend("np")
    return sb


class CriticalStage:
    """Critical extraction + per-dimension rank sort."""

    name = "extract_sort"

    def run(self, state: PipelineState, cfg, rep: StageReport) -> None:
        state.ci = sandwich_of(cfg).extract(state.grid, state.gf,
                                            state.order)


def _pair_graph(g, cfg, rep: StageReport, prefix: str):
    """The configured extremum-saddle pairing engine on a graph: the
    distributed self-correcting rounds (with their counters) or the
    sandwich back-end's."""
    if cfg.distributed:
        from repro_torch.distributed.pairing_rounds import pairing_fixpoint
        p, st = pairing_fixpoint(g, collect_stats=True)
        rep.count(**{prefix + "_rounds": st.rounds})
        if prefix == "d0":
            rep.count(d0_corrections=st.corrections)
        return p
    return sandwich_of(cfg).pair_d0(g)


class D0Stage:
    """D0 on the primal extremum graph (minimum-saddle pairs)."""

    name = "d0"

    def run(self, state: PipelineState, cfg, rep: StageReport) -> None:
        grid, ci = state.grid, state.ci
        if grid.dim >= 1:
            dev = state.order.device
            with sub_span("graph", dev):
                g = build_d0_graph(grid, state.gf, ci)
            with sub_span("fixpoint", dev):
                p0 = _pair_graph(g, cfg, rep, "d0")
            state.pairs[0] = as_pairs(p0.extrema, p0.saddles)
            state.essential[0] = _sorted(_minus(ci.crit_sids[0], p0.extrema))
            state.d0_saddles = p0.saddles
        else:
            state.pairs[0] = as_pairs(ci.crit_sids[0][:0], ci.crit_sids[0][:0])
            state.essential[0] = ci.crit_sids[0].long()


class DualStage:
    """D_{d-1} on the dual graph (saddle-maximum pairs) + essential[d]."""

    name = "d_top"

    def run(self, state: PipelineState, cfg, rep: StageReport) -> None:
        grid, ci = state.grid, state.ci
        d = grid.dim
        if d >= 2:
            state.dual_saddles = (_minus(ci.crit_sids[1], state.d0_saddles)
                                  if d == 2 else ci.crit_sids[d - 1])
            pD = _pair_graph(sandwich_of(cfg).build_dual(
                grid, state.gf, ci, state.dual_saddles), cfg, rep, "d_top")
            state.pairs[d - 1] = as_pairs(pD.saddles, pD.extrema)
            state.essential[d] = _sorted(_minus(ci.crit_sids[d], pD.extrema))
            state.dual_paired_saddles = pD.saddles
        elif d == 1:
            state.essential[1] = _sorted(_minus(ci.crit_sids[1],
                                                state.d0_saddles))


class D1Stage:
    """D1 by homologous propagation on the unpaired leftovers (3-D)."""

    name = "d1"

    def run(self, state: PipelineState, cfg, rep: StageReport) -> None:
        grid, ci = state.grid, state.ci
        d = grid.dim
        if d == 3:
            c1 = _minus(ci.crit_sids[1], state.d0_saddles)
            c2 = _minus(ci.crit_sids[2], state.dual_paired_saddles)
            if cfg.distributed:
                from repro_torch.distributed.d1_rounds import d1_distributed
                ss, st1 = d1_distributed(
                    grid, state.gf, ci, c1, c2, cfg.n_blocks,
                    anticipation=cfg.anticipation, budget=cfg.budget)
                rep.count(d1_rounds=st1.rounds, d1_token_hops=st1.token_hops,
                          d1_expansions=st1.expansions, d1_merges=st1.merges,
                          d1_steals=st1.steals)
            else:
                ss = sandwich_of(cfg).pair_d1(grid, state.gf, ci, c1, c2)
                rep.count(d1_expansions=ss.expansions)
                if ss.rounds is not None:
                    rep.count(d1_rounds=ss.rounds)
            state.pairs[1] = as_pairs(ss.pairs[:, 0], ss.pairs[:, 1])
            state.essential[1] = ss.unpaired_edges.long()
            state.essential[2] = ss.unpaired_triangles.long()
        elif d == 2:
            state.essential[1] = _sorted(_minus(state.dual_saddles,
                                                state.dual_paired_saddles))


FRONT_STAGES = (OrderStage(), GradientStage(), CriticalStage())
BACK_STAGES = (D0Stage(), DualStage(), D1Stage())
ALL_STAGES = FRONT_STAGES + BACK_STAGES


def run_stages(state: PipelineState, cfg, report: StageReport,
               stages=ALL_STAGES) -> PipelineState:
    """Run a stage chain over ``state``, timing each into ``report``."""
    for st in stages:
        with report.stage(st.name) as rep:
            st.run(state, cfg, rep)
    return state
