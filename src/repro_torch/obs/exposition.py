"""Prometheus text exposition for :class:`MetricsRegistry`.

The port's copy of ``repro.obs.exposition``.  Three pieces, all
stdlib-only:

- :func:`render_prometheus` — render one or more registries in the
  Prometheus text format (version 0.0.4): counters as ``<name>_total``,
  gauges as scalars, histograms with **cumulative** ``_bucket{le=...}``
  series plus ``_sum``/``_count`` (the semantics
  :meth:`Histogram.buckets` provides).  Metric names are converted to
  Prometheus-legal form in exactly one place, :func:`prometheus_name`
  (dotted scheme ``service.queue_depth`` → ``service_queue_depth``).
- :func:`serve_metrics` / :class:`MetricsServer` — a ``/metrics``
  scrape endpoint on ``http.server`` (daemon thread, ``port=0`` picks
  a free port); ``TopoService(metrics_port=...)`` embeds one over its
  private registry + the process-global one.
- :class:`SnapshotLogger` — periodic JSON-line snapshots of a registry
  to any sink (default stderr), for environments without a scraper.

:func:`parse_prometheus_text` is the matching reader: it validates the
exposition shape (TYPE lines, cumulative monotone buckets closed by
``+Inf == _count``) and returns the samples — CI's schema check and the
benchmarks use it; the test suite carries its *own* independent parser
so the renderer and this reader are never graded by each other alone.

Bucket upper edges come from the log-histogram's geometric bounds;
Prometheus's ``le`` is inclusive while our buckets are right-open —
the boundary discrepancy is at most the one sample sitting exactly on
an edge, far inside the histogram's documented quantile error.
"""

from __future__ import annotations

import http.server
import json
import math
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      global_metrics)

__all__ = ["prometheus_name", "render_prometheus", "serve_metrics",
           "MetricsServer", "SnapshotLogger", "parse_prometheus_text"]

_ILLEGAL = re.compile(r"[^a-zA-Z0-9_:]")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def prometheus_name(name: str) -> str:
    """THE single point where metric names become Prometheus-legal:
    every illegal character (the dots of the canonical scheme included)
    maps to ``_``; a leading digit gets a ``_`` prefix."""
    out = _ILLEGAL.sub("_", name)
    if not out:
        return "_"
    if not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if v != v:                          # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_le(v: float) -> str:
    return "+Inf" if v == math.inf else f"{v:.6g}"


def render_prometheus(registries: Union[MetricsRegistry,
                                        Sequence[MetricsRegistry]]) -> str:
    """Prometheus text format of one or more registries.

    Later registries never shadow earlier ones: on a name collision the
    first instrument wins (the embedded service endpoint lists its
    private registry before the process-global one)."""
    if isinstance(registries, MetricsRegistry):
        registries = [registries]
    merged: Dict[str, object] = {}
    for reg in registries:
        for name, m in reg.instruments().items():
            merged.setdefault(name, m)
    lines: List[str] = []
    emitted = set()                    # aliases share instruments, not names
    for name in sorted(merged):
        m = merged[name]
        pname = prometheus_name(name)
        if pname in emitted:
            continue
        emitted.add(pname)
        if isinstance(m, Counter):
            total = pname if pname.endswith("_total") else pname + "_total"
            lines.append(f"# TYPE {total} counter")
            lines.append(f"{total} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            for le, cum in m.buckets():
                lines.append(f'{pname}_bucket{{le="{_fmt_le(le)}"}} {cum}')
            lines.append(f"{pname}_sum {_fmt(m.sum)}")
            lines.append(f"{pname}_count {m.count}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse + validate an exposition document.

    Returns ``{metric_name: {"type": ..., "samples": {sample: value}}}``
    (histogram bucket samples keyed ``name_bucket{le="..."}``).  Raises
    ``ValueError`` on malformed lines, unknown sample names, buckets
    that are not cumulative-monotone, or a ``+Inf`` bucket that
    disagrees with ``_count``."""
    metrics: Dict[str, dict] = {}
    cur: Optional[str] = None
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "histogram"):
                raise ValueError(f"bad TYPE line: {ln!r}")
            cur = parts[2]
            metrics[cur] = {"type": parts[3], "samples": {}}
            continue
        if ln.startswith("#"):
            continue
        m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                     r'(\{[^}]*\})?\s+(\S+)$', ln)
        if not m:
            raise ValueError(f"bad sample line: {ln!r}")
        name, labels, val = m.group(1), m.group(2) or "", m.group(3)
        if cur is None or not name.startswith(cur):
            raise ValueError(f"sample {name!r} outside its TYPE block")
        try:
            v = float(val)
        except ValueError:
            raise ValueError(f"bad value in {ln!r}")
        metrics[cur]["samples"][name + labels] = v
    # histogram shape: cumulative buckets closed by +Inf == _count
    for name, md in metrics.items():
        if md["type"] != "histogram":
            continue
        buckets = []
        for key, v in md["samples"].items():
            bm = re.match(rf'^{re.escape(name)}_bucket\{{le="([^"]+)"\}}$',
                          key)
            if bm:
                le = math.inf if bm.group(1) == "+Inf" \
                    else float(bm.group(1))
                buckets.append((le, v))
        if not buckets or buckets[-1][0] != math.inf:
            raise ValueError(f"{name}: missing +Inf bucket")
        les = [le for le, _ in buckets]
        cums = [c for _, c in buckets]
        if les != sorted(les) or cums != sorted(cums):
            raise ValueError(f"{name}: buckets not cumulative-monotone")
        count = md["samples"].get(f"{name}_count")
        if count is None or f"{name}_sum" not in md["samples"]:
            raise ValueError(f"{name}: missing _sum/_count")
        if cums[-1] != count:
            raise ValueError(
                f"{name}: +Inf bucket {cums[-1]} != count {count}")
    return metrics


# --------------------------------------------------------------------------
# scrape endpoint
# --------------------------------------------------------------------------

class MetricsServer:
    """``/metrics`` over stdlib ``http.server``, rendered fresh per
    scrape from live registries.  ``port=0`` binds a free port (read
    ``self.port`` / ``self.url``); the serving thread is a daemon, but
    call :meth:`close` for a deterministic shutdown."""

    def __init__(self, registries, port: int = 0,
                 host: str = "127.0.0.1"):
        regs = list(registries) if isinstance(registries, (list, tuple)) \
            else [registries]

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 - stdlib naming
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = render_prometheus(regs).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # pragma: no cover - silence
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self.url = f"http://{host}:{self.port}/metrics"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="metrics-http")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_metrics(registry: Union[MetricsRegistry,
                                  Sequence[MetricsRegistry], None] = None,
                  port: int = 0, host: str = "127.0.0.1") -> MetricsServer:
    """Start a scrape endpoint for ``registry`` (default: the
    process-global registry); returns the live :class:`MetricsServer`."""
    if registry is None:
        registry = global_metrics()
    return MetricsServer(registry, port=port, host=host)


# --------------------------------------------------------------------------
# periodic snapshot logger
# --------------------------------------------------------------------------

class SnapshotLogger:
    """Emit a JSON line of ``registry.snapshot()`` every ``interval_s``
    to ``sink`` (a ``callable(str)``; default writes to stderr) — the
    pull-less fallback when no scraper exists.  ``tick()`` emits one
    line synchronously (deterministic for tests)."""

    def __init__(self, registry: MetricsRegistry,
                 interval_s: float = 60.0, sink=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.interval_s = float(interval_s)
        self._sink = sink
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> str:
        line = json.dumps({"t": time.time(),
                           "metrics": self.registry.snapshot()},
                          sort_keys=True, default=str)
        if self._sink is not None:
            self._sink(line)
        else:                           # pragma: no cover - default sink
            import sys
            sys.stderr.write(line + "\n")
        return line

    def start(self) -> "SnapshotLogger":
        if self._thread is not None:
            raise RuntimeError("SnapshotLogger already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-snapshot")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:           # pragma: no cover - must survive
                pass

    def __enter__(self) -> "SnapshotLogger":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
