"""Flight recorder: always-on ring of recent events for post-mortems.

Tracing (:mod:`repro_torch.obs.trace`) answers *what happened* — if the run
finished and someone asked for ``trace=True`` up front.  The failure
modes that matter at scale (a shard deadlocked on a halo plane, a
worker thread dead from an unhandled exception, a service wedged
mid-batch) leave neither: the process dies or hangs with no artifact.
The flight recorder closes that gap the way aircraft FDRs do — it is
**always on**, it retains only the recent past, and it is cheap enough
to never turn off:

- every thread records into its own fixed-capacity ring
  (:class:`_Ring`): preallocated parallel slot lists written in place,
  so the hot path takes **no lock** and allocates **no per-event
  containers** — the only lock guards first-touch ring registration,
  exactly like ``Trace``'s buffer registration;
- it is fed from the *existing* span/instant instrumentation: a
  :class:`FlightRecorder` is the default ``sink`` on every
  :class:`~repro_torch.obs.trace.Trace`, and the **process-global default
  recorder** (:func:`default_recorder`) also receives events from
  ``maybe_span``/``StageReport.stage`` hooks when *no* trace is active
  — so an untraced production run still has its last-N-events tail;
- :meth:`FlightRecorder.dump` writes two artifacts: a
  Perfetto-compatible ``trace_event`` JSON tail (load it at
  ``ui.perfetto.dev``) and a human-readable text post-mortem (per
  thread: the retained events with ages; plus the global metrics
  snapshot and live thread stacks via ``sys._current_frames`` +
  ``faulthandler``).

Dumps fire automatically (through :func:`crash_dump`, rate-limited per
reason) on ``HaloExchangeTimeout``, ``GradientInvariantError``,
``CritCapacityError``, unhandled worker exceptions in the stream
engines and ``TopoService``, on watchdog stalls
(:mod:`repro_torch.obs.watchdog`), and on ``SIGUSR1`` (handler installed at
import when the signal is still at its default disposition — kill
``-USR1`` a live process to get a dump without stopping it).

The :func:`~repro_torch.obs.trace.set_enabled` kill switch covers this module
too: with tracing disabled, :func:`active_recorder` reports None and
every hook is a read-and-return.

Readers of a live ring may observe one torn in-flight record (the
writer holds no lock); dumps are post-mortem artifacts, not
consistency proofs.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from . import trace as _trace
from .metrics import global_metrics

__all__ = ["FlightRecorder", "default_recorder", "active_recorder",
           "record_event", "crash_dump", "dump_on_error",
           "install_signal_dump", "set_dump_dir", "thread_stacks"]

_PID = 1
DEFAULT_CAPACITY = 1024          # events retained per thread


class _Ring:
    """Fixed-capacity per-thread event ring (written by its owner only).

    Parallel preallocated slot lists, overwritten in place modulo
    capacity: recording is a few index stores — no lock, no container
    allocation.  ``n`` counts every event ever written, so readers know
    both the tail window and the drop count."""

    __slots__ = ("tid", "ident", "name", "cap", "n",
                 "names", "t0s", "durs", "metas")

    def __init__(self, tid: int, ident: int, name: str, cap: int):
        self.tid = tid
        self.ident = ident
        self.name = name
        self.cap = cap
        self.n = 0
        self.names: List[Optional[str]] = [None] * cap
        self.t0s: List[float] = [0.0] * cap
        self.durs: List[float] = [0.0] * cap
        self.metas: List[Any] = [None] * cap

    def put(self, name: str, t0: float, dur: float, meta) -> None:
        i = self.n % self.cap
        self.names[i] = name
        self.t0s[i] = t0
        self.durs[i] = dur
        self.metas[i] = meta
        self.n += 1

    def tail(self) -> List[Tuple[str, float, float, Any]]:
        """Chronological ``(name, t0, dur, meta)`` of retained events."""
        n = self.n
        out = []
        for j in range(max(0, n - self.cap), n):
            i = j % self.cap
            out.append((self.names[i], self.t0s[i], self.durs[i],
                        self.metas[i]))
        return out


class FlightRecorder:
    """Per-thread lock-free ring buffers of compact recent events.

    ``record(name, t0, dur, meta)`` is the single hot-path entry
    (timestamps are raw ``time.perf_counter`` values); ``instant``
    records a zero-duration marker.  Export mirrors ``Trace``:
    :meth:`to_dict` builds a Perfetto ``trace_event`` document of the
    retained tail, :meth:`post_mortem` a human-readable text report,
    and :meth:`dump` writes both to disk."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.epoch = time.perf_counter()
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._lock = threading.Lock()

    # -- recording (hot path) ---------------------------------------------

    def record(self, name: str, t0: float, dur: float, meta=None) -> None:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = self._register()
        ring.put(name, t0, dur, meta)

    def instant(self, name: str, meta=None) -> None:
        self.record(name, time.perf_counter(), 0.0, meta)

    def _register(self) -> _Ring:
        th = threading.current_thread()
        with self._lock:
            ring = _Ring(len(self._rings) + 1, th.ident or 0, th.name,
                         self.capacity)
            self._rings.append(ring)
        self._local.ring = ring
        return ring

    # -- reading / export --------------------------------------------------

    def _snapshot(self) -> List[_Ring]:
        with self._lock:
            return list(self._rings)

    def event_count(self) -> int:
        """Total events ever recorded (including overwritten ones)."""
        return sum(r.n for r in self._snapshot())

    def events(self) -> List[dict]:
        """Retained events across all threads, ordered by start time."""
        out = []
        for ring in self._snapshot():
            for name, t0, dur, meta in ring.tail():
                out.append({"name": name, "ts": t0 - self.epoch,
                            "dur": dur, "tid": ring.tid,
                            "thread": ring.name, "meta": meta})
        out.sort(key=lambda e: e["ts"])
        return out

    def to_dict(self) -> dict:
        """Perfetto ``trace_event`` JSON object document of the tail."""
        rings = self._snapshot()
        ev: List[dict] = []
        spans = []
        for ring in rings:
            for name, t0, dur, meta in ring.tail():
                spans.append((t0, dur, ring.tid, name, meta))
        spans.sort(key=lambda s: s[0])
        for ring in sorted(rings, key=lambda r: r.tid):
            ev.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": ring.tid, "args": {"name": ring.name}})
        for t0, dur, tid, name, meta in spans:
            args = {}
            if isinstance(meta, dict):
                args = {k: _trace._jsonable(v) for k, v in meta.items()}
            elif meta is not None:
                args = {"meta": _trace._jsonable(meta)}
            ev.append({"name": str(name), "ph": "X", "pid": _PID,
                       "tid": tid, "ts": max(0.0, (t0 - self.epoch) * 1e6),
                       "dur": max(0.0, dur * 1e6), "cat": "flight",
                       "args": args})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def post_mortem(self, reason: str = "", exc: Optional[BaseException]
                    = None, stacks: bool = True) -> str:
        """Human-readable tail: per-thread recent events with ages,
        the global metrics snapshot, and (optionally) live stacks."""
        now = time.perf_counter()
        lines = ["== flight recorder post-mortem ==",
                 f"reason: {reason or 'manual'}",
                 f"wall clock: {time.strftime('%Y-%m-%dT%H:%M:%S')}"]
        if exc is not None:
            lines.append("exception: " + "".join(
                traceback.format_exception_only(type(exc), exc)).strip())
        lines.append("")
        for ring in self._snapshot():
            tail = ring.tail()
            lines.append(f"-- thread {ring.name} (tid {ring.tid}, "
                         f"{ring.n} events, {len(tail)} retained) --")
            for name, t0, dur, meta in tail[-40:]:
                age = now - (t0 + dur)
                meta_s = f"  {meta}" if meta else ""
                lines.append(f"  {age * 1e3:10.1f}ms ago  {name}"
                             f"  dur={dur * 1e3:.3f}ms{meta_s}")
            lines.append("")
        lines.append("-- global metrics --")
        try:
            lines.append(json.dumps(global_metrics().snapshot(),
                                    sort_keys=True, default=str))
        except Exception as e:          # pragma: no cover - diagnostics only
            lines.append(f"<metrics snapshot failed: {e}>")
        if stacks:
            lines.append("")
            lines.append("-- thread stacks (sys._current_frames) --")
            for label, stack in thread_stacks().items():
                lines.append(f"[{label}]")
                lines.append(stack.rstrip())
        lines.append("")
        return "\n".join(lines)

    def dump(self, reason: str = "manual",
             exc: Optional[BaseException] = None,
             directory: Optional[str] = None,
             stacks: bool = True) -> Tuple[str, str]:
        """Write the Perfetto JSON tail + the text post-mortem; returns
        ``(json_path, text_path)``.  Never raises for a full disk or a
        bad directory *after* creation — a dump is best-effort by
        design, but a nonexistent parent still errors loudly here (the
        caller picked it)."""
        directory = directory or _dump_dir()
        os.makedirs(directory, exist_ok=True)
        global _DUMP_SEQ
        with _DUMP_LOCK:
            _DUMP_SEQ += 1
            seq = _DUMP_SEQ
        tag = "".join(c if c.isalnum() or c in "-_" else "_"
                      for c in reason)[:80] or "dump"
        base = os.path.join(directory, f"flight-{seq:03d}-{tag}")
        json_path, txt_path = base + ".trace.json", base + ".txt"
        with open(json_path, "w") as fh:
            json.dump(self.to_dict(), fh)
        with open(txt_path, "w") as fh:
            fh.write(self.post_mortem(reason=reason, exc=exc,
                                      stacks=stacks))
            fh.write("\n-- faulthandler --\n")
            try:
                faulthandler.dump_traceback(file=fh)
            except Exception:           # pragma: no cover - best effort
                pass
        return json_path, txt_path


def thread_stacks() -> Dict[str, str]:
    """Formatted stack of every live thread, labeled by thread name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, '?')} ({ident})"
        out[label] = "".join(traceback.format_stack(frame))
    return out


# --------------------------------------------------------------------------
# process-global default recorder + automatic dump triggers
# --------------------------------------------------------------------------

_DEFAULT = FlightRecorder()
_DUMP_DIR: Optional[str] = None
_DUMP_SEQ = 0
_DUMP_LOCK = threading.Lock()
_LAST_DUMP: Dict[str, float] = {}
MIN_DUMP_INTERVAL_S = 1.0        # per-reason rate limit for crash_dump


def default_recorder() -> FlightRecorder:
    """The process-global always-on recorder."""
    return _DEFAULT


def active_recorder() -> Optional[FlightRecorder]:
    """The recorder hot paths should feed, or None when the
    :func:`~repro_torch.obs.trace.set_enabled` kill switch is off."""
    if not _trace._ENABLED:
        return None
    return _DEFAULT


def record_event(name: str, t0: float, dur: float, meta=None) -> None:
    """Feed one already-timed event to the default recorder (no-op —
    one global read, zero allocation — when the kill switch is off)."""
    if not _trace._ENABLED:
        return
    _DEFAULT.record(name, t0, dur, meta)


def set_dump_dir(path: Optional[str]) -> None:
    """Where automatic dumps land; None resets to the default
    (``$REPRO_FLIGHT_DIR`` or ``./flight_dumps``)."""
    global _DUMP_DIR
    _DUMP_DIR = str(path) if path is not None else None


def _dump_dir() -> str:
    return _DUMP_DIR or os.environ.get("REPRO_FLIGHT_DIR", "flight_dumps")


def crash_dump(reason: str, exc: Optional[BaseException] = None,
               min_interval_s: float = MIN_DUMP_INTERVAL_S
               ) -> Optional[Tuple[str, str]]:
    """Best-effort automatic dump of the default recorder.

    Rate-limited per ``reason`` (a failing storm produces one artifact
    per interval, not thousands); marks ``exc`` as dumped so nested
    handlers (:func:`dump_on_error` above a raising layer that already
    dumped) do not double-dump; returns the paths or None (disabled /
    rate-limited / dump itself failed — a dump must never mask the
    original error)."""
    rec = active_recorder()
    if rec is None:
        return None
    if exc is not None:
        if getattr(exc, "_flight_dumped", False):
            return None
        try:
            exc._flight_dumped = True
        except Exception:               # pragma: no cover - exotic excs
            pass
    now = time.monotonic()
    with _DUMP_LOCK:
        last = _LAST_DUMP.get(reason)
        if last is not None and now - last < min_interval_s:
            return None
        _LAST_DUMP[reason] = now
    try:
        paths = rec.dump(reason=reason, exc=exc)
        sys.stderr.write(f"[flight] dumped post-mortem ({reason}): "
                         f"{paths[1]}\n")
        return paths
    except Exception:
        return None


@contextmanager
def dump_on_error(context: str):
    """Wrap a worker body: any escaping exception triggers a flight
    dump tagged ``context:ExcType`` (once per exception object), then
    re-raises untouched."""
    try:
        yield
    except BaseException as e:
        crash_dump(f"{context}:{type(e).__name__}", exc=e)
        raise


def install_signal_dump(signum: Optional[int] = None) -> bool:
    """Install a ``SIGUSR1`` (by default) handler that fires
    :func:`crash_dump`.  Returns False off the main thread or on
    platforms without the signal — never raises."""
    if signum is None:
        signum = getattr(signal, "SIGUSR1", None)
        if signum is None:              # pragma: no cover - windows
            return False

    def _handle(sig, frame):
        crash_dump(f"signal{sig}")

    try:
        signal.signal(signum, _handle)
        return True
    except ValueError:                  # not the main thread
        return False


def _maybe_autoinstall() -> None:
    """At import: claim SIGUSR1 only if nobody else has (default
    disposition), so a host application's own handler is never
    clobbered."""
    signum = getattr(signal, "SIGUSR1", None)
    if signum is None:                  # pragma: no cover - windows
        return
    try:
        if signal.getsignal(signum) == signal.SIG_DFL:
            install_signal_dump(signum)
    except (ValueError, TypeError):     # pragma: no cover
        pass


_maybe_autoinstall()
