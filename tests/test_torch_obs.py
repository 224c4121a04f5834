"""PyTorch port, observability of this slice on the CPU: the Prometheus
exposition (``repro_torch.obs.exposition``) against the JAX package's for
identically filled registries, its scrape endpoint and snapshot logger;
``TopoRequest(trace=True)`` runs (one span per stage, bit-identical to an
untraced run, streamed chunk spans, the same D0 / D1 round spans and
round counters as the JAX package's, the port's device-timed sub-spans
and D0's host-sync counter, none of them in an untraced run); and the
plan cache's process-wide counters."""

import collections
import json
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import grid as JG
from repro.obs import exposition as JX
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.metrics import global_metrics as j_global_metrics
from repro.pipeline import PersistencePipeline as JPipeline
from repro.pipeline import TopoRequest as JRequest

from repro_torch.core.grid import Grid
from repro_torch.fields.generators import make_field
from repro_torch.obs import (MetricsRegistry, SnapshotLogger,
                             default_recorder, global_metrics,
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


# the device-timed sub-spans of a traced run: flat key -> least grid dim
SUB_SPANS = {"gradient.rows": 0, "gradient.scatter": 0,
             "extract_sort.select": 0, "extract_sort.sort": 0,
             "extract_sort.edge_keys": 1, "extract_sort.ranks": 2,
             "d0.graph": 1, "d0.fixpoint": 1}
# the dense edge keys, built under the first stage that reads them: the
# dual graph in 2-D, D1 in 3-D (grid dim -> flat key)
DENSE_EDGE_KEYS = {2: "d_top.edge_keys", 3: "d1.edge_keys"}


def _raise(*a, **kw):
    raise AssertionError("an untraced run made a CUDA event or a "
                         "profiler range")


@pytest.mark.parametrize("name,dims,hdims", [("isabel", (8, 7, 6), None),
                                             ("random", (9, 8), None),
                                             ("wavelet", (12,), None),
                                             ("random", (9, 8, 7), (0,))])
def test_traced_run_is_bit_identical(name, dims, hdims, monkeypatch):
    f = make_field(name, dims, seed=1)
    pipe = PersistencePipeline(device="cpu")
    req = TopoRequest(field=f, grid=Grid.of(*dims), homology_dims=hdims)
    flight = []
    rec = default_recorder()
    with monkeypatch.context() as m:
        # the untraced path makes no event, range or sub-span record
        m.setattr(torch.cuda, "Event", _raise)
        m.setattr(torch.profiler, "record_function", _raise)
        m.setattr(rec, "record", lambda n, *a, **kw: flight.append(n))
        plain = pipe.run(req)
    assert flight and not [n for n in flight if "." in n]
    assert not set(plain.stats) & (set(SUB_SPANS) | {"d0_host_syncs"})
    rounds = global_metrics().counter("pairing.d0_rounds")
    before = rounds.value
    traced = pipe.run(req.replace(trace=True))
    assert plain.trace is None and traced.trace is not None
    assert traced.to_bytes() == plain.to_bytes()
    doc = traced.trace.to_dict()
    validate_trace_events(doc)
    spans = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    # one span per stage; the D0 / D1 round spans and the sub-spans nest
    # inside them
    assert [n for n in spans if n in STAGES] == list(traced.plan.stage_names)
    assert set(spans) <= set(STAGES) | {"d0_round", "d1_round"} \
        | set(SUB_SPANS) | set(DENSE_EDGE_KEYS.values())
    want = {k for k, d in SUB_SPANS.items() if len(dims) >= d}
    # a D0-only diagram never builds them, a full one once
    dense = DENSE_EDGE_KEYS.get(len(dims)) if hdims is None else None
    assert [n for n in spans if n in DENSE_EDGE_KEYS.values()] == \
        ([dense] if dense else [])
    if dense:
        stage = dense.split(".")[0]
        assert traced.stats[stage + "_dense_edge_keys"] == 1
        assert traced.stats[dense] <= traced.stats[stage]
    assert sum(v for k, v in traced.stats.items()
               if k.endswith("_dense_edge_keys")) == (1 if dense else 0)
    assert want <= set(traced.stats) and want <= set(spans)
    for k in want:
        stage = k.split(".")[0]
        outer = [e for e in doc["traceEvents"] if e["name"] == stage][0]
        for e in doc["traceEvents"]:
            if e["name"] == k:
                assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= \
                    outer["ts"] + outer["dur"] + 0.5, k
    for stage in ("gradient", "extract_sort", "d0"):
        parts = [traced.stats[k] for k in want if k.startswith(stage + ".")]
        assert sum(parts) <= traced.stats[stage], stage
    # a jump's read, the last find's and at least one torch.equal a round
    syncs = sum(v for k, v in traced.stats.items()
                if k.endswith("_host_syncs"))
    assert syncs >= 2 * (rounds.value - before) > 0
    if hdims == (0,):
        assert syncs == traced.stats["d0_host_syncs"]
    d1 = [e for e in doc["traceEvents"] if e["name"] == "d1"]
    if len(dims) == 3 and "d1" in traced.plan.stage_names:
        assert d1[0]["args"]["d1_rounds"] == traced.stats["d1_rounds"]
    # a batch with a traced member serves it alone, with its own trace
    outs = pipe.run_batch([req, req.replace(trace=True), req])
    assert [o.trace is None for o in outs] == [True, False, True]
    assert all(o.to_bytes() == plain.to_bytes() for o in outs)


ROUND_COUNTERS = ("pairing.d0_rounds", "pairing.d1_rounds")


@pytest.mark.parametrize("dims,n_blocks", [((16, 16, 16), 1),
                                           ((8, 8, 8), 2)])
def test_round_spans_and_counters_match_reference(dims, n_blocks):
    """A traced run lists the reference's spans, ``d0_round`` (each D0 /
    dual pairing round) and ``d1_round`` (each D1 round: the wavefront's
    batched path at 16^3, the token engine of the distributed back-end at
    n_blocks=2), as many of each, and bumps ``pairing.d0_rounds`` /
    ``pairing.d1_rounds`` by the same amounts; its other spans are the
    port's sub-spans."""
    f = make_field("random", dims, seed=1)

    def run(pipe, req, registry):
        before = [registry.counter(k).value for k in ROUND_COUNTERS]
        res = pipe.run(req)
        after = [registry.counter(k).value for k in ROUND_COUNTERS]
        names = collections.Counter(
            e["name"] for e in res.trace.to_dict()["traceEvents"]
            if e["ph"] == "X")
        return res, names, [b - a for a, b in zip(before, after)]

    want, want_spans, want_inc = run(
        JPipeline(backend="jax", n_blocks=n_blocks),
        JRequest(field=f, grid=JG.Grid.of(*dims), trace=True),
        j_global_metrics())
    got, got_spans, got_inc = run(
        PersistencePipeline(device="cpu", n_blocks=n_blocks),
        TopoRequest(field=f, grid=Grid.of(*dims), trace=True),
        global_metrics())
    assert got.to_bytes() == want.to_bytes()
    # the reference's spans as many times; besides them the port's
    # device-timed sub-spans only
    assert {k: v for k, v in got_spans.items() if k in want_spans} == \
        want_spans
    assert set(got_spans) - set(want_spans) <= set(SUB_SPANS) \
        | set(DENSE_EDGE_KEYS.values())
    assert got_spans["d0_round"] > 0 and got_spans["d1_round"] > 0
    assert got_inc == want_inc and got_inc[1] == got.stats["d1_rounds"]


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
