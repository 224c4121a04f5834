"""Stall watchdog: turn silent hangs into structured stall reports.

The paper's distributed pairing coordinates shards through computation
tokens and a communication thread — precisely the shape whose dominant
failure mode is a *quiet* hang: one shard stops making progress (a
halo plane never arrives, a worker wedges inside a kernel) and the
whole run sits at 0% CPU with nothing to debug from.  The watchdog
makes progress an observable:

- hot loops call :func:`progress(name)` — one module-global read and a
  dict lookup, no lock, no allocation when no watchdog is running (the
  common case, and the ``set_enabled(False)`` kill switch forces it);
- an *armed lane* (:meth:`ProgressWatchdog.register`, or the scoped
  :func:`lane` context manager the engines use) must beat within its
  deadline; beats on unknown names auto-create **passive** lanes that
  count progress for reports but never alarm — so one-shot beat sites
  (``halo.publish``) enrich the report without false positives;
- when an armed lane goes quiet past its deadline the watchdog thread
  emits a structured stall report — offending lane, seconds quiet,
  every lane's beat counters (per-shard chunk/round progress), the
  global + any lane-attached metrics registries (queue depths), and
  live thread stacks via ``sys._current_frames`` — and fires a flight
  recorder dump (``stall:<lane>``), so the post-mortem artifact exists
  *while the process is still hung*.

Lanes that resume beating after a stall are re-armed automatically
(one report per stall episode, not per poll tick).

Instrumented lanes (armed while the activity is in flight):

- ``stream.chunks`` / ``stream.shard<s>`` — the chunk loops;
- ``halo.recv.shard<s>.<side>`` — a blocking halo wait (armed inside
  :meth:`HaloExchange.recv`, so a delayed/dropped neighbor plane is
  named directly);
- ``pairing.d0`` / ``pairing.d1`` — the distributed round loops;
- ``service.worker`` — a ``TopoService`` batch in flight.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from . import trace as _trace
from .metrics import MetricsRegistry, global_metrics

__all__ = ["ProgressWatchdog", "active_watchdog", "progress", "lane",
           "format_stall_report"]

DEFAULT_DEADLINE_S = 60.0


class _Lane:
    __slots__ = ("name", "deadline_s", "armed", "last", "beats",
                 "stalled", "metrics")

    def __init__(self, name: str, deadline_s: float, armed: bool,
                 metrics: Optional[MetricsRegistry] = None):
        self.name = name
        self.deadline_s = deadline_s
        self.armed = armed
        self.last = time.monotonic()
        self.beats = 0
        self.stalled = False
        self.metrics = metrics


_ACTIVE: Optional["ProgressWatchdog"] = None   # the running watchdog


def active_watchdog() -> Optional["ProgressWatchdog"]:
    """The currently running watchdog, or None."""
    return _ACTIVE


def progress(name: str) -> None:
    """Heartbeat: cheap enough for per-chunk / per-round call sites.

    With no watchdog running (or the kill switch off) this is a global
    read and a return — zero locks, zero allocation.  Beats on names
    without a lane auto-create a passive (non-alarming) one."""
    wd = _ACTIVE
    if wd is None or not _trace._ENABLED:
        return
    ln = wd._lanes.get(name)
    if ln is None:
        ln = wd._ensure_lane(name)
    ln.last = time.monotonic()
    ln.beats += 1


@contextmanager
def lane(name: str, deadline_s: Optional[float] = None,
         metrics: Optional[MetricsRegistry] = None):
    """Arm an alarming lane for the duration of an activity.

    No-op (yields None) when no watchdog is running or the obs kill
    switch is off — instrumented engines call this unconditionally."""
    wd = _ACTIVE
    if wd is None or not _trace._ENABLED:
        yield None
        return
    ln = wd.register(name, deadline_s=deadline_s, metrics=metrics)
    try:
        yield ln
    finally:
        wd.unregister(name)


class ProgressWatchdog:
    """Deadline monitor over named progress lanes.

    ``start()`` spawns the daemon poll thread and makes this instance
    the process-wide beat target (:func:`progress`); ``stop()``
    restores the previous state.  Usable as a context manager.  Stall
    reports accumulate on ``self.reports`` (plain dicts, also handed
    to ``on_stall`` and — unless ``flight_dump=False`` — mirrored into
    a flight-recorder dump).

    ``check_now()`` runs one poll synchronously — deterministic hook
    for tests and for callers that manage their own cadence."""

    def __init__(self, deadline_s: float = DEFAULT_DEADLINE_S,
                 poll_s: Optional[float] = None,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 flight_dump: bool = True):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(0.01, min(1.0, self.deadline_s / 4))
        self.on_stall = on_stall
        self.flight_dump = flight_dump
        self.reports: List[dict] = []
        self._lanes: Dict[str, _Lane] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Optional[ProgressWatchdog] = None

    # -- lanes -------------------------------------------------------------

    def register(self, name: str, deadline_s: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None) -> _Lane:
        """Arm an alarming lane (re-arming an existing one resets it)."""
        ln = _Lane(name, deadline_s or self.deadline_s, armed=True,
                   metrics=metrics)
        with self._lock:
            self._lanes[name] = ln
        return ln

    def unregister(self, name: str) -> None:
        with self._lock:
            self._lanes.pop(name, None)

    def _ensure_lane(self, name: str) -> _Lane:
        """Get-or-create the passive lane behind an unarmed beat."""
        with self._lock:
            ln = self._lanes.get(name)
            if ln is None:
                ln = _Lane(name, self.deadline_s, armed=False)
                self._lanes[name] = ln
            return ln

    def lanes(self) -> Dict[str, dict]:
        """name -> {age_s, beats, deadline_s, armed, stalled} snapshot."""
        now = time.monotonic()
        with self._lock:
            lanes = list(self._lanes.values())
        return {ln.name: {"age_s": now - ln.last, "beats": ln.beats,
                          "deadline_s": ln.deadline_s, "armed": ln.armed,
                          "stalled": ln.stalled} for ln in lanes}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ProgressWatchdog":
        global _ACTIVE
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        self._prev, _ACTIVE = _ACTIVE, self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="progress-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        global _ACTIVE
        if self._thread is None:
            return
        if _ACTIVE is self:
            _ACTIVE = self._prev
        self._stop.set()
        self._thread.join()
        self._thread = None
        self._prev = None

    def __enter__(self) -> "ProgressWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_now()
            except Exception:           # pragma: no cover - must survive
                pass

    # -- detection ---------------------------------------------------------

    def check_now(self) -> List[dict]:
        """One poll: report every armed lane newly quiet past deadline;
        lanes that resumed beating are re-armed for the next episode."""
        now = time.monotonic()
        with self._lock:
            lanes = list(self._lanes.values())
        fired = []
        for ln in lanes:
            quiet = now - ln.last
            if ln.stalled:
                if quiet < ln.deadline_s:
                    ln.stalled = False          # recovered: re-arm
                continue
            if ln.armed and quiet > ln.deadline_s:
                ln.stalled = True
                rpt = self.stall_report(ln, quiet)
                self.reports.append(rpt)
                fired.append(rpt)
                self._emit(rpt)
        return fired

    def stall_report(self, ln: _Lane, quiet_s: float) -> dict:
        """The structured stall artifact for one quiet lane."""
        from . import flight
        rpt = {"lane": ln.name, "quiet_s": quiet_s,
               "deadline_s": ln.deadline_s, "beats": ln.beats,
               "lanes": self.lanes(),
               "metrics": global_metrics().snapshot()}
        if ln.metrics is not None:
            rpt["lane_metrics"] = ln.metrics.snapshot()
        try:
            rpt["last_events"] = [
                {k: e[k] for k in ("name", "thread", "ts", "dur")}
                for e in flight.default_recorder().events()[-12:]]
        except Exception:               # pragma: no cover - diagnostics
            rpt["last_events"] = []
        rpt["threads"] = flight.thread_stacks()
        return rpt

    def _emit(self, rpt: dict) -> None:
        sys.stderr.write(format_stall_report(rpt))
        if self.flight_dump:
            from . import flight
            paths = flight.crash_dump("stall:" + rpt["lane"])
            rpt["flight_dump"] = list(paths) if paths else None
        if self.on_stall is not None:
            try:
                self.on_stall(rpt)
            except Exception:           # pragma: no cover - user callback
                pass


def format_stall_report(rpt: dict) -> str:
    """Render one stall report for humans (stderr / log files)."""
    lines = ["== watchdog stall report ==",
             f"lane {rpt['lane']!r} quiet {rpt['quiet_s']:.2f}s "
             f"(deadline {rpt['deadline_s']:.2f}s, "
             f"{rpt['beats']} beats so far)",
             "-- lanes --"]
    for name, st in sorted(rpt.get("lanes", {}).items()):
        mark = "STALLED" if st["stalled"] else \
            ("armed" if st["armed"] else "passive")
        lines.append(f"  {name}: {st['beats']} beats, "
                     f"quiet {st['age_s']:.2f}s [{mark}]")
    ev = rpt.get("last_events") or []
    if ev:
        lines.append("-- last flight events --")
        for e in ev:
            lines.append(f"  {e['thread']}: {e['name']} "
                         f"(+{e['ts'] * 1e3:.1f}ms, "
                         f"dur {e['dur'] * 1e3:.3f}ms)")
    lines.append("-- thread stacks --")
    for label, stack in rpt.get("threads", {}).items():
        lines.append(f"[{label}]")
        lines.append(stack.rstrip())
    lines.append("")
    return "\n".join(lines)
