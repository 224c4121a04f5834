"""PyTorch port, serving (``repro_torch.serve``) on the CPU.

``TopoService`` batching, failure isolation, the diagram cache (hits
across backends and across array / tensor spellings, ``cache=False`` /
``True``), progressive previews, forced degradation and shedding, and
``serve_topo`` / ``stats_payload`` — with every served payload held byte
for byte to the JAX package's pipeline on the same request.  Every
future wait has a timeout, and every service is closed."""

import json
import threading

import numpy as np
import pytest
import torch

from repro.core import grid as JG
from repro.pipeline import PersistencePipeline as JPipeline
from repro.pipeline import TopoRequest as JRequest
from repro.serve import serve_topo as j_serve_topo

from repro_torch.cache import (AdmissionPolicy, CacheKeyError, DiagramCache,
                               ServiceOverloadedError)
from repro_torch.core.grid import Grid
from repro_torch.fields.generators import make_field
from repro_torch.pipeline import DiagramResult, PersistencePipeline, TopoRequest
from repro_torch.serve import (ProgressiveFuture, TopoService, serve_topo,
                               stats_payload, topo_payload)
from repro_torch.stream import ArraySource, FunctionSource

DIMS = (8, 8, 8)
WAIT = 120


def _vol(name="wavelet", seed=0, dims=DIMS):
    return make_field(name, dims, seed=seed).reshape(dims[::-1])


def _want(v, **kw):
    """The JAX package's payload of the same request."""
    return JPipeline(backend="jax").run(JRequest(field=v, **kw)).to_bytes()


def _svc(**kw):
    kw.setdefault("device", "cpu")
    return TopoService(**kw)


def test_batches_same_shape_submits_from_threads():
    vols = [_vol(n, s) for n, s in (("random", 1), ("wavelet", 2),
                                    ("isabel", 3), ("magnetic", 4))]
    # the batch closes when all four are in; the long window only keeps a
    # slow client thread from missing it
    with _svc(max_batch=4, max_wait_s=10.0) as svc:
        futs = [None] * 4
        start = threading.Barrier(4)

        def client(i):
            start.wait()
            futs[i] = svc.submit(torch.from_numpy(vols[i]) if i % 2
                                 else vols[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
        got = [f.result(timeout=WAIT) for f in futs]
        assert svc.stats.batches == 1 and svc.stats.max_batch == 4
        assert svc.stats.batched_requests == 4
        snap = svc.stats()
        assert snap["metrics"]["service.batch_size"]["count"] == 1
    run = PersistencePipeline(device="cpu")
    for v, res in zip(vols, got):
        assert res.to_bytes() == run.run(TopoRequest(field=v)).to_bytes() \
            == _want(v)


class _Poisoned(PersistencePipeline):
    """Fails every dispatch that holds the field whose first value is
    the poison."""

    POISON = -12345.0

    def _check(self, reqs):
        for r in reqs:
            if float(np.asarray(r.field).reshape(-1)[0]) == self.POISON:
                raise RuntimeError("poisoned field")

    def run(self, request, grid=None, **kw):
        self._check([request])
        return super().run(request, grid, **kw)

    def run_batch(self, requests):
        self._check(requests)
        return super().run_batch(requests)


def test_failure_isolation():
    good, bad = _vol(), _vol(seed=5)
    bad = bad.copy()
    bad.reshape(-1)[0] = _Poisoned.POISON
    with _svc(pipeline=_Poisoned(device="cpu"), max_batch=3,
              max_wait_s=10.0) as svc:
        futs = [svc.submit(v) for v in (good, bad, good)]
        assert futs[0].result(timeout=WAIT).to_bytes() == _want(good)
        with pytest.raises(RuntimeError, match="poisoned"):
            futs[1].result(timeout=WAIT)
        assert futs[2].result(timeout=WAIT).to_bytes() == _want(good)
        assert svc.stats.errors == 1 and svc.stats.retried == 3
        # the worker survives and serves the next request
        assert svc.diagram(good).to_bytes() == _want(good)


def test_cache_hits_across_backends_and_spellings():
    v = _vol("isabel")
    with _svc(cache=DiagramCache()) as svc:
        first = svc.submit(v).result(timeout=WAIT)
        # the same field as a tensor, through another backend: a hit
        hits = [svc.submit(TopoRequest(field=torch.from_numpy(v),
                                       backend=b)).result(timeout=WAIT)
                for b in ("torch", "prepass")]
        # an exact entry serves any epsilon
        eps = svc.submit(TopoRequest(field=v, epsilon=1.0)).result(
            timeout=WAIT)
        assert svc.stats.cache_misses == 1 and svc.stats.cache_hits == 3
        assert svc.stats()["cache"]["size"] == 1
    for r in hits + [eps]:
        assert r.diagram is None              # decoded from the payload
        assert r.to_bytes() == first.to_bytes() == _want(v)


def test_cache_opt_out_and_required_key():
    v = _vol()
    anon = FunctionSource(lambda zlo, zhi: _vol()[zlo:zhi], DIMS)
    with _svc(cache=True) as svc:
        svc.submit(TopoRequest(field=v, cache=False)).result(timeout=WAIT)
        svc.submit(TopoRequest(field=v, cache=False)).result(timeout=WAIT)
        assert svc.stats.cache_hits == svc.stats.cache_misses == 0
        assert len(svc.cache) == 0
        with pytest.raises(CacheKeyError):
            svc.submit(TopoRequest(field=anon, cache=True)).result(
                timeout=WAIT)
        # an unfingerprintable source by default computes, uncached
        res = svc.submit(anon).result(timeout=WAIT)
        assert res.to_bytes() == _want(v)
        # a traced request bypasses the cache and keeps its timeline
        tr = svc.submit(TopoRequest(field=v, trace=True)).result(
            timeout=WAIT)
        assert tr.trace is not None and svc.stats.traced_requests == 1
    with _svc(cache=False) as svc:
        assert svc.cache is None
        svc.diagram(v)
        assert svc.stats.cache_misses == 0


def test_progressive_preview_then_final_and_cache_upgrade():
    v = _vol("wavelet", dims=(12, 12, 12))
    want = JPipeline(backend="jax").run(JRequest(field=v, progressive=True))
    with _svc(cache=True) as svc:
        fut = svc.submit(TopoRequest(field=v, progressive=True))
        assert isinstance(fut, ProgressiveFuture)
        preview = fut.preview.result(timeout=WAIT)
        final = fut.result(timeout=WAIT)
        assert preview.error_bound > final.error_bound == 0.0
        bounds = [r.error_bound for r in fut.partials]
        assert bounds == sorted(bounds, reverse=True)
        assert final.to_bytes() == want.to_bytes()
        ent = svc.cache.peek(TopoRequest(field=v).cache_key())
        assert ent.exact and ent.upgrades == len(fut.partials) - 1
        # a later epsilon request is served from the refined entry
        hit = svc.submit(TopoRequest(field=v, epsilon=0.5)).result(
            timeout=WAIT)
        assert svc.stats.cache_hits == 1
        assert hit.to_bytes() == final.to_bytes()
        assert svc.stats.progressive_requests == 1


def test_progressive_failure_fails_both_futures():
    class Boom:
        dims = (4, 4, 4)

        def read_slab(self, zlo, zhi):
            raise RuntimeError("poisoned source")

    with _svc() as svc:
        fut = svc.submit(TopoRequest(field=Boom(), progressive=True))
        with pytest.raises(RuntimeError, match="poisoned"):
            fut.result(timeout=WAIT)
        with pytest.raises(RuntimeError, match="poisoned"):
            fut.preview.result(timeout=WAIT)
        assert svc.stats.errors == 1


def test_wire_mode_payloads_decode():
    v = _vol("random", dims=(8, 8, 8))
    with _svc(wire=True, cache=True) as svc:
        blob = svc.submit(v).result(timeout=WAIT)
        again = svc.submit(torch.from_numpy(v)).result(timeout=WAIT)
        fut = svc.submit(TopoRequest(field=v, progressive=True))
        prev = DiagramResult.from_bytes(fut.preview.result(timeout=WAIT))
        final = fut.result(timeout=WAIT)
    assert isinstance(blob, bytes) and blob == again == _want(v)
    assert prev.error_bound is not None
    assert DiagramResult.from_bytes(final).error_bound == 0.0


def test_forced_degrade_and_shed():
    v = _vol("isabel", dims=(12, 12, 12))
    pol = AdmissionPolicy(degrade_depth=0, shed_depth=None,
                          degrade_frac=0.2)
    with _svc(admission=pol) as svc:
        res = svc.submit(torch.from_numpy(v)).result(timeout=WAIT)
        assert svc.stats.degraded == 1
        eps = 0.2 * float(v.max() - v.min())
        assert res.error_bound is not None and res.error_bound <= eps
        assert res.to_bytes() == _want(v, epsilon=eps)
    with _svc(admission=AdmissionPolicy(degrade_depth=0, shed_depth=0)) \
            as svc:
        with pytest.raises(ServiceOverloadedError) as ei:
            svc.submit(v)
        assert ei.value.retry_after_s > 0 and svc.stats.shed == 1
        assert svc.stats()["metrics"]["service.admission.shed"] == 1


def test_serve_topo_and_stats_payload():
    v = _vol("magnetic")
    pipe = PersistencePipeline(device="cpu")
    for kw in ({}, dict(epsilon=0.3), dict(top_k=4, homology_dims=(0, 2))):
        blob = serve_topo(TopoRequest(field=v, **kw), pipeline=pipe)
        want = j_serve_topo(JRequest(field=v, **kw),
                            pipeline=JPipeline(backend="jax"))
        assert blob == want
    assert topo_payload(pipe.run(TopoRequest(field=v))) == _want(v)
    with _svc() as svc:
        svc.diagram(v)
        doc = json.loads(stats_payload(svc))
    assert doc["requests"] == 1 and doc["batches"] == 1
    assert "service.request_latency_s" in doc["metrics"]


def test_streamed_submit_and_closed_service():
    v = _vol("random", seed=7)
    with _svc() as svc:
        res = svc.submit(ArraySource(v)).result(timeout=WAIT)
        assert res.stream is not None and svc.stats.stream_requests == 1
        assert res.to_bytes() == _want(v)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(v)
    grids = [Grid.of(*DIMS), None]
    with _svc() as svc:
        out = svc.map([v.reshape(-1), v], grid=grids)
    assert out[0].to_bytes() == out[1].to_bytes() == _want(v)
