"""PyTorch port, observability of this slice on the CPU: the Prometheus
exposition (``repro_torch.obs.exposition``) against the JAX package's for
identically filled registries, its scrape endpoint and snapshot logger;
``TopoRequest(trace=True)`` runs (one span per stage, bit-identical to an
untraced run, streamed chunk spans); and the plan cache's process-wide
counters."""

import json
import urllib.request

import numpy as np
import pytest

from repro.obs import exposition as JX
from repro.obs.metrics import MetricsRegistry as JRegistry

from repro_torch.core.grid import Grid
from repro_torch.fields.generators import make_field
from repro_torch.obs import (MetricsRegistry, SnapshotLogger, global_metrics,
                             parse_prometheus_text, prometheus_name,
                             render_prometheus, serve_metrics,
                             validate_trace_events)
from repro_torch.pipeline import PersistencePipeline, PlanCache, TopoRequest
from repro_torch.serve import TopoService
from repro_torch.stream import ArraySource

STAGES = ("order", "gradient", "extract_sort", "d0", "d_top", "d1")


def _fill(reg):
    reg.counter("pairing.d0_rounds").inc(7)
    reg.counter("service.cache.hits", alias="cache.hits").inc(5)
    reg.gauge("service.queue_depth").set(3)
    reg.gauge("9bad name!").set(-2.5)
    h = reg.histogram("service.request_latency_s")
    for v in (0.001, 0.02, 0.02, 1.5, 1e-9, 1e9):
        h.observe(v)
    b = reg.histogram("service.batch_size", lo=1.0, hi=4096.0, factor=2.0)
    for v in (1, 4, 4, 8):
        b.observe(v)
    return reg


def test_render_matches_reference():
    mine, theirs = _fill(MetricsRegistry()), _fill(JRegistry())
    text = render_prometheus(mine)
    assert text == JX.render_prometheus(theirs)
    assert parse_prometheus_text(text) == JX.parse_prometheus_text(text)
    other, jother = MetricsRegistry(), JRegistry()
    other.gauge("service.queue_depth").set(99)
    assert render_prometheus([mine, other]) == \
        JX.render_prometheus([theirs, jother])
    assert render_prometheus(MetricsRegistry()) == "\n"
    for name in ("a.b", "9x", "ok_name", "x-y:z", ""):
        assert prometheus_name(name) == JX.prometheus_name(name)
    with pytest.raises(ValueError):
        parse_prometheus_text('# TYPE h histogram\nh_bucket{le="+Inf"} 3\n'
                              'h_sum 1\nh_count 2\n')


def test_scrape_endpoint_and_snapshot_logger():
    reg = _fill(MetricsRegistry())
    with serve_metrics(reg) as srv:
        body = urllib.request.urlopen(srv.url, timeout=30).read().decode()
        assert body == render_prometheus(reg)
        reg.counter("pairing.d0_rounds").inc()
        body = urllib.request.urlopen(srv.url, timeout=30).read().decode()
        assert "pairing_d0_rounds_total 8" in body
    lines = []
    line = SnapshotLogger(reg, sink=lines.append).tick()
    assert lines == [line]
    assert json.loads(line)["metrics"]["pairing.d0_rounds"] == 8
    with pytest.raises(ValueError):
        SnapshotLogger(reg, interval_s=0)


def test_service_embeds_metrics_endpoint():
    v = make_field("wavelet", (6, 6, 6), seed=0).reshape(6, 6, 6)
    with TopoService(device="cpu", metrics_port=0) as svc:
        svc.submit(v).result(timeout=120)
        body = urllib.request.urlopen(svc.metrics_server.url,
                                      timeout=30).read().decode()
    doc = parse_prometheus_text(body)
    assert doc["service_request_latency_s"]["type"] == "histogram"
    assert "plan_cache_hits_total" in doc


@pytest.mark.parametrize("name,dims", [("isabel", (8, 7, 6)),
                                       ("random", (9, 8)),
                                       ("wavelet", (12,))])
def test_traced_run_is_bit_identical(name, dims):
    f = make_field(name, dims, seed=1)
    pipe = PersistencePipeline(device="cpu")
    req = TopoRequest(field=f, grid=Grid.of(*dims))
    plain = pipe.run(req)
    traced = pipe.run(req.replace(trace=True))
    assert plain.trace is None and traced.trace is not None
    assert traced.to_bytes() == plain.to_bytes()
    doc = traced.trace.to_dict()
    validate_trace_events(doc)
    spans = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert spans == list(traced.plan.stage_names)
    assert set(spans) <= set(STAGES)
    d1 = [e for e in doc["traceEvents"] if e["name"] == "d1"]
    if len(dims) == 3:
        assert d1[0]["args"]["d1_rounds"] == traced.stats["d1_rounds"]
    # a batch with a traced member serves it alone, with its own trace
    outs = pipe.run_batch([req, req.replace(trace=True), req])
    assert [o.trace is None for o in outs] == [True, False, True]
    assert all(o.to_bytes() == plain.to_bytes() for o in outs)


def test_traced_streamed_run_has_chunk_spans(tmp_path):
    dims = (8, 8, 12)
    v = make_field("random", dims, seed=2).reshape(dims[::-1])
    pipe = PersistencePipeline(device="cpu")
    plain = pipe.run(TopoRequest(field=ArraySource(v), chunk_z=4))
    traced = pipe.run(TopoRequest(field=ArraySource(v), chunk_z=4,
                                  trace=True))
    assert traced.to_bytes() == plain.to_bytes()
    doc = traced.trace.to_dict()
    validate_trace_events(doc)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    for n in ("gradient", "chunk_load", "chunk_compute", "chunk_scatter",
              "extract_sort", "d1", "rank_translate"):
        assert n in names, n
    assert names.count("chunk_compute") == 3
    path = tmp_path / "run.trace.json"
    traced.trace.to_perfetto(str(path))
    assert json.loads(path.read_text())["traceEvents"]


def test_plan_cache_counters():
    g = global_metrics()
    before = {k: g.counter(f"plan_cache.{k}").value
              for k in ("hits", "misses", "evictions")}
    cache = PlanCache(maxsize=1)
    pipe = PersistencePipeline(device="cpu", plan_cache=cache)
    for dims in ((4, 4, 4), (4, 4, 4), (5, 4, 3)):
        pipe.run(TopoRequest(field=np.zeros(dims[::-1], np.float32)))
    assert cache.stats() == dict(size=1, hits=1, misses=2, evictions=1)
    after = {k: g.counter(f"plan_cache.{k}").value for k in before}
    assert {k: after[k] - before[k] for k in after} == \
        dict(hits=1, misses=2, evictions=1)
