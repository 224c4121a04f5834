"""Diagram serving at the RPC boundary: payloads, not live objects.

The topology half of ``repro.serve.engine``:
:func:`serve_topo` runs one :class:`~repro_torch.pipeline.TopoRequest`
and returns the DDMS v1 wire payload (``bytes``, decodable by either
package's ``DiagramResult.from_bytes``); :func:`stats_payload` is a
:class:`~repro_torch.serve.TopoService`'s telemetry as JSON bytes.  The
language-model decode half (``generate``) comes with the LM substrate
(ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import json


def topo_payload(result) -> bytes:
    """Serialize a :class:`DiagramResult` for the RPC boundary."""
    return result.to_bytes()


def serve_topo(request, *, pipeline=None) -> bytes:
    """Execute one :class:`TopoRequest` and return its wire payload.

    ``pipeline`` is an optional configured :class:`PersistencePipeline`;
    the default one runs on the card."""
    from repro_torch.pipeline import PersistencePipeline
    pipe = pipeline or PersistencePipeline()
    return topo_payload(pipe.run(request))


def stats_payload(service) -> bytes:
    """A :class:`TopoService`'s telemetry snapshot as JSON bytes: the
    serving counters and the metric summaries of ``service.stats()`` (a
    copy, never a view of live state)."""
    return json.dumps(service.stats(), sort_keys=True).encode("utf-8")
