"""Span-based tracing: nested, thread-aware spans on one timeline.

The paper's central *measured* claims — a dedicated communication
thread whose collectives hide behind compute (Sec. V-C), pairing
rounds that converge — are timeline statements, not scalars.  This
module records them as **spans**: named intervals with attributes,
captured per thread into append-only buffers (no lock on the hot
path — each thread only ever appends to its own list) and exported as
Chrome/Perfetto ``trace_event`` JSON, so the stream scheduler's loader
thread, per-shard host threads, ``HaloExchange`` publishes/receives,
chunk kernels, and the D0/D1 pairing rounds all appear on one timeline
and comm/compute overlap becomes *visible* rather than a derived
scalar.

Design:

- a :class:`Trace` owns the run: an epoch (``time.perf_counter`` at
  construction), per-thread event buffers, and thread-name metadata.
  Threads register lazily on their first span; buffers are plain lists
  appended from their owning thread only ("lock-free-ish": the only
  lock guards buffer *creation*).
- ``trace.span(name, **attrs)`` is a context manager yielding the live
  :class:`Span`; attributes may be added until exit.  Nesting needs no
  explicit parent links: Chrome ``"X"`` (complete) events nest by time
  containment per thread, which the :func:`validate_trace_events`
  sanity check enforces (same-thread spans must nest or be disjoint —
  partial overlap means the instrumentation itself is broken).
- deep layers (pairing kernels, distributed rounds) find the active
  trace through :func:`current_trace`, a *thread-local* activation set
  by ``PersistencePipeline.run`` for ``TopoRequest(trace=True)`` runs.
  Worker threads spawned by the stream engines get the trace by
  explicit capture instead, so a traced run and an untraced run on
  another thread never cross-contaminate.
- when no trace is active every hook is one thread-local read and a
  ``None`` check; the ``BENCH_obs.json`` benchmark gates this disabled
  overhead at < 3% of an end-to-end pipeline run.

Export: :meth:`Trace.to_perfetto` writes the standard JSON object
format (``{"traceEvents": [...]}``) — load it at ``ui.perfetto.dev``
or ``chrome://tracing``.  Timestamps are microseconds since the trace
epoch; thread names ride on ``"M"`` metadata events.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Trace", "current_trace", "trace_active",
           "maybe_span", "set_enabled", "is_enabled",
           "validate_trace_events", "spans_overlap", "thread_names"]

_PID = 1          # single-process runs: one constant pid lane

# Trace(sink=DEFAULT_SINK): resolve to the process flight recorder at
# record time (respecting the kill switch); None disables the feed
DEFAULT_SINK = object()

_FLIGHT = None    # lazily imported repro_torch.obs.flight (avoids the cycle)


def _flight_active():
    """The active flight recorder, or None (kill switch off).  Lazy
    import: ``repro_torch.obs.flight`` imports this module at top level, so
    the reverse edge resolves at first use."""
    global _FLIGHT
    if _FLIGHT is None:
        from . import flight as _FLIGHT  # noqa: F811 - module cache
    return _FLIGHT.active_recorder()


class Span:
    """One named interval on one thread (mutable until closed).

    ``ts``/``dur`` are seconds relative to the owning trace's epoch;
    ``args`` is the attribute dict shown by the trace viewer."""

    __slots__ = ("name", "ts", "dur", "tid", "args")

    def __init__(self, name: str, ts: float, tid: int,
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.ts = ts
        self.dur = 0.0
        self.tid = tid
        self.args = dict(args) if args else {}

    def to_dict(self) -> dict:
        return {"name": self.name, "ts": self.ts, "dur": self.dur,
                "tid": self.tid, "args": dict(self.args)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, ts={self.ts * 1e3:.3f}ms, "
                f"dur={self.dur * 1e3:.3f}ms, tid={self.tid})")


class _ThreadBuf:
    """Per-thread append-only span buffer (owned by exactly one thread)."""

    __slots__ = ("tid", "name", "spans")

    def __init__(self, tid: int, name: str):
        self.tid = tid
        self.name = name
        self.spans: List[Span] = []


class Trace:
    """Process-wide span collection for one traced run.

    Cheap to create, safe to write from any number of threads: each
    thread appends to its own buffer; the only lock guards buffer
    registration.  Reading (:meth:`events`, :meth:`to_perfetto`) is
    meant for after the run — concurrent readers see a consistent
    prefix of each thread's spans."""

    def __init__(self, sink=DEFAULT_SINK):
        self.epoch = time.perf_counter()
        self._local = threading.local()
        self._bufs: List[_ThreadBuf] = []
        self._lock = threading.Lock()
        # every closed span/instant is also fed to ``sink`` — by
        # default the process flight recorder (resolved per record so
        # the kill switch applies live); an explicit FlightRecorder
        # pins one, None opts out
        self.sink = sink

    def _sink(self):
        s = self.sink
        return _flight_active() if s is DEFAULT_SINK else s

    # -- recording ---------------------------------------------------------

    def _buf(self) -> _ThreadBuf:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            with self._lock:
                buf = _ThreadBuf(len(self._bufs) + 1,
                                 threading.current_thread().name)
                self._bufs.append(buf)
            self._local.buf = buf
        return buf

    @contextmanager
    def span(self, name: str, **attrs):
        """Open a span on the calling thread; yields the live
        :class:`Span` so attributes can be attached until exit."""
        buf = self._buf()
        t0 = time.perf_counter()
        # one t0 for both the timestamp and the duration origin, so a
        # child's recorded interval nests *exactly* inside its parent's
        # (the validator's same-thread containment check relies on it)
        sp = Span(name, t0 - self.epoch, buf.tid, attrs)
        buf.spans.append(sp)
        try:
            yield sp
        finally:
            sp.dur = time.perf_counter() - t0
            rec = self._sink()
            if rec is not None:
                rec.record(name, t0, sp.dur, sp.args or None)

    def complete(self, name: str, t0: float, **attrs) -> Span:
        """Record an already-measured interval: started at
        ``perf_counter`` time ``t0``, ending now.  For loops that
        cannot wrap their round body in a ``with`` block (e.g. bodies
        with ``continue`` paths)."""
        buf = self._buf()
        sp = Span(name, t0 - self.epoch, buf.tid, attrs)
        sp.dur = time.perf_counter() - t0
        buf.spans.append(sp)
        rec = self._sink()
        if rec is not None:
            rec.record(name, t0, sp.dur, sp.args or None)
        return sp

    def instant(self, name: str, **attrs) -> Span:
        """Record a zero-duration marker on the calling thread."""
        buf = self._buf()
        t0 = time.perf_counter()
        sp = Span(name, t0 - self.epoch, buf.tid, attrs)
        buf.spans.append(sp)
        rec = self._sink()
        if rec is not None:
            rec.record(name, t0, 0.0, sp.args or None)
        return sp

    # -- reading / export --------------------------------------------------

    def thread_names(self) -> Dict[int, str]:
        """tid -> thread name for every thread that recorded a span."""
        with self._lock:
            return {b.tid: b.name for b in self._bufs}

    def events(self) -> List[Span]:
        """All recorded spans, ordered by start time."""
        with self._lock:
            bufs = list(self._bufs)
        out = [sp for b in bufs for sp in list(b.spans)]
        out.sort(key=lambda s: s.ts)
        return out

    def to_dict(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object format.

        Spans are snapshotted *before* thread metadata: a thread that
        registers its buffer mid-export can add a name the span list
        does not reference yet (harmless), but never a span whose tid
        lacks a ``thread_name`` metadata event."""
        spans = self.events()
        ev: List[dict] = []
        for tid, name in sorted(self.thread_names().items()):
            ev.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": name}})
        for sp in spans:
            ev.append({"name": sp.name, "ph": "X", "pid": _PID,
                       "tid": sp.tid, "ts": sp.ts * 1e6,
                       "dur": sp.dur * 1e6, "cat": "repro",
                       "args": {k: _jsonable(v)
                                for k, v in sp.args.items()}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def to_perfetto(self, path) -> str:
        """Write the trace as Perfetto-loadable JSON; returns the path."""
        doc = self.to_dict()
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return str(path)


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return v.item()          # numpy scalars
    except AttributeError:
        return str(v)


# --------------------------------------------------------------------------
# thread-local activation (the untraced fast path is one getattr + check)
# --------------------------------------------------------------------------

_ACTIVE = threading.local()
_ENABLED = True


def set_enabled(flag: bool) -> None:
    """Process-wide kill switch for the whole obs layer: with
    ``False``, :func:`current_trace` reports no active trace even
    inside an activation window, the flight recorder stops receiving
    events (``flight.active_recorder()`` is None), and watchdog
    heartbeats (``watchdog.progress``/``lane``) become pure no-ops —
    the baseline the disabled-overhead benchmark measures against."""
    global _ENABLED
    _ENABLED = bool(flag)


def is_enabled() -> bool:
    """Current state of the obs kill switch."""
    return _ENABLED


def current_trace() -> Optional[Trace]:
    """The trace active on *this thread*, or None.

    Deep layers (pairing kernels, distributed round engines) hook in
    through this instead of threading a trace argument through every
    signature; worker threads spawned by the stream engines capture
    the trace object explicitly instead."""
    if not _ENABLED:
        return None
    return getattr(_ACTIVE, "trace", None)


@contextmanager
def maybe_span(trace: Optional[Trace], name: str, **attrs):
    """``trace.span(...)`` when ``trace`` is a Trace; otherwise the
    interval is still timed into the process **flight recorder** (the
    always-on last-N-events tail — see :mod:`repro_torch.obs.flight`) unless
    the kill switch is off, in which case this is a no-op yielding
    None — the one-liner instrumented loops use on every path."""
    if trace is not None:
        with trace.span(name, **attrs) as sp:
            yield sp
        return
    rec = _flight_active()
    if rec is None:
        yield None
        return
    t0 = time.perf_counter()
    try:
        yield None
    finally:
        rec.record(name, t0, time.perf_counter() - t0, attrs or None)


@contextmanager
def trace_active(trace: Optional[Trace]):
    """Activate ``trace`` for the calling thread (no-op for None)."""
    prev = getattr(_ACTIVE, "trace", None)
    _ACTIVE.trace = trace if trace is not None else prev
    try:
        yield trace
    finally:
        _ACTIVE.trace = prev


# --------------------------------------------------------------------------
# trace-event validation + timeline queries (CI + benchmark checks)
# --------------------------------------------------------------------------

def validate_trace_events(doc: dict) -> List[dict]:
    """Validate a Chrome ``trace_event`` JSON object document.

    Checks the structural schema (``traceEvents`` list; every event has
    ``name``/``ph``/``pid``/``tid``; ``"X"`` events carry finite
    non-negative ``ts``/``dur``) and the *catastrophic-overlap* sanity
    invariant: two complete events on the same thread must nest or be
    disjoint — a partial overlap cannot be produced by well-formed
    enter/exit instrumentation and would render garbage in the viewer.
    Returns the ``"X"`` events; raises ``ValueError`` on any violation.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace_event JSON object document "
                         "(missing 'traceEvents')")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    xs: List[dict] = []
    for i, ev in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}: {ev}")
        if ev["ph"] == "M":
            continue
        if ev["ph"] != "X":
            raise ValueError(
                f"event {i}: unsupported phase {ev['ph']!r} "
                f"(exporter only emits 'X' and 'M')")
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or not ts >= 0:
            raise ValueError(f"event {i} ({ev['name']}): bad ts {ts!r}")
        if not isinstance(dur, (int, float)) or not dur >= 0:
            raise ValueError(f"event {i} ({ev['name']}): bad dur {dur!r}")
        xs.append(ev)

    # catastrophic overlap: same-tid complete events must nest properly
    # (tolerance 0.5us — clock reads are ns-resolution, so a genuine
    # partial overlap from broken instrumentation dwarfs it)
    tol = 0.5
    by_tid: Dict[int, List[dict]] = {}
    for ev in xs:
        by_tid.setdefault(ev["tid"], []).append(ev)
    for tid, evs in by_tid.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        for ev in evs:
            while stack and ev["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] \
                    - tol:
                stack.pop()
            if stack:
                outer = stack[-1]
                if ev["ts"] + ev["dur"] > outer["ts"] + outer["dur"] + tol:
                    raise ValueError(
                        f"catastrophic overlap on tid {tid}: "
                        f"{ev['name']!r} [{ev['ts']:.1f}, "
                        f"{ev['ts'] + ev['dur']:.1f}]us partially overlaps "
                        f"{outer['name']!r} [{outer['ts']:.1f}, "
                        f"{outer['ts'] + outer['dur']:.1f}]us")
            stack.append(ev)
    return xs


def thread_names(doc: dict) -> Dict[int, str]:
    """tid -> name from a trace_event document's metadata events."""
    return {ev["tid"]: ev["args"]["name"]
            for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"}


def spans_overlap(doc_or_events, name_a: str, name_b: str) -> bool:
    """True iff some ``name_a`` span overlaps some ``name_b`` span in
    wall time (any threads).  This is the machine check behind "halo
    receives hide behind chunk compute": a ``halo_recv`` interval
    intersecting a ``chunk_compute`` interval on the shared timeline.
    """
    events = doc_or_events.get("traceEvents", []) \
        if isinstance(doc_or_events, dict) else doc_or_events
    def ivals(name):
        out = []
        for ev in events:
            if ev.get("ph") == "X" and ev.get("name") == name:
                out.append((ev["ts"], ev["ts"] + ev["dur"]))
        return sorted(out)
    a, b = ivals(name_a), ivals(name_b)
    j = 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        if j < len(b) and b[j][0] < hi:
            return True
    return False
