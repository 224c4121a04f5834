"""Batched persistence-diagram serving (PyTorch counterpart of
``repro.serve``, without the LM ``generate``).

:class:`TopoService` coalesces concurrent requests into batched pipeline
dispatches on the pipeline's device, answers progressive requests with a
coarse preview and then refinements, fronts the epsilon-aware
:class:`DiagramCache`, and applies an :class:`AdmissionPolicy`;
:func:`serve_topo` / :func:`topo_payload` give wire payloads and
:func:`stats_payload` the service's telemetry.
"""

from repro_torch.cache import (AdmissionPolicy, DiagramCache,  # noqa: F401
                               ServiceOverloadedError)

from repro_torch.obs.exposition import (MetricsServer,  # noqa: F401
                                        serve_metrics)

from .engine import serve_topo, stats_payload, topo_payload  # noqa: F401
from .topo_service import (ProgressiveFuture, ServiceStats,  # noqa: F401
                           TopoService)
