"""Process-wide observability: tracing, metrics, flight recorder and
stall watchdog (the port's own copies of ``repro.obs``, pure Python).

- :mod:`repro_torch.obs.trace`    — nested, thread-aware spans exported
  as Chrome/Perfetto ``trace_event`` JSON; the streaming engines open
  per-chunk load / compute / scatter and halo publish / receive spans.
- :mod:`repro_torch.obs.metrics`  — named counters, gauges and streaming
  histograms (``stream.chunks``, ``stream.loaded_bytes``,
  ``halo.planes``).
- :mod:`repro_torch.obs.flight`   — the always-on post-mortem layer:
  per-thread ring buffers dumped on halo timeouts, unhandled worker
  exceptions, watchdog stalls and ``SIGUSR1``.
- :mod:`repro_torch.obs.watchdog` — progress lanes fed by
  ``progress(name)`` heartbeats from the chunk and halo loops.
- :mod:`repro_torch.obs.exposition` — Prometheus text rendering of any
  registry, the ``serve_metrics`` / ``MetricsServer`` scrape endpoint
  (embedded in ``TopoService(metrics_port=...)``) and the periodic
  ``SnapshotLogger``.

``TopoRequest(trace=True)`` records one run's stage spans and their
device-timed sub-spans (``result.trace``, ``result.stats``).
``set_enabled(False)`` is the one kill switch.
"""

from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, global_metrics)
from .trace import (Span, Trace, current_trace,  # noqa: F401
                    is_enabled, maybe_span, set_enabled, spans_overlap,
                    thread_names, trace_active, validate_trace_events)
from .flight import (FlightRecorder, crash_dump,  # noqa: F401
                     default_recorder, dump_on_error, install_signal_dump,
                     record_event, set_dump_dir, thread_stacks)
from .watchdog import (ProgressWatchdog, active_watchdog,  # noqa: F401
                       format_stall_report, lane, progress)
from .exposition import (MetricsServer, SnapshotLogger,  # noqa: F401
                         parse_prometheus_text, prometheus_name,
                         render_prometheus, serve_metrics)
