"""PyTorch port, diagram cache and admission (``repro_torch.cache``)
against the JAX package's ``repro.cache`` on the CPU.

``request_key`` equals the reference's for numpy arrays, CPU tensors and
every source kind; ``DiagramCache`` and ``AdmissionPolicy`` run the same
scripted operations as the reference's and give the same answers and
counters; ``degrade_request`` grants the same epsilon (a tensor's range
read with one ``aminmax``)."""

import numpy as np
import pytest
import torch

from repro import cache as J
from repro.core import grid as JG
from repro.pipeline import TopoRequest as JRequest
from repro.stream import ArraySource as JArraySource
from repro.stream import DecimatedSource as JDecimatedSource
from repro.stream import FunctionSource as JFunctionSource
from repro.stream import MemmapSource as JMemmapSource

from repro_torch import cache as P
from repro_torch.core.grid import Grid
from repro_torch.fields.generators import make_field
from repro_torch.pipeline import TopoRequest
from repro_torch.stream import (ArraySource, DecimatedSource, FunctionSource,
                                MemmapSource)

DIMS = (8, 8, 8)


def _vol(name="wavelet", dims=DIMS, seed=0):
    return make_field(name, dims, seed=seed).reshape(dims[::-1])


# --------------------------------------------------------------------------
# fingerprints and keys
# --------------------------------------------------------------------------

def _sources(tmp_path):
    v = _vol()
    path = str(tmp_path / "f.raw")
    MemmapSource.write(path, v)
    return {
        "array": (ArraySource(v), JArraySource(v)),
        "memmap": (MemmapSource(path, DIMS), JMemmapSource(path, DIMS)),
        "function": (FunctionSource.synthetic("random", DIMS, seed=3),
                     JFunctionSource.synthetic("random", DIMS, seed=3)),
        "decimated": (DecimatedSource(ArraySource(v), 2),
                      JDecimatedSource(JArraySource(v), 2)),
    }


@pytest.mark.parametrize("kind", ["array", "memmap", "function",
                                  "decimated"])
def test_request_key_of_sources_matches_reference(tmp_path, kind):
    mine, theirs = _sources(tmp_path)[kind]
    assert mine.fingerprint() == theirs.fingerprint()
    for kw in ({}, dict(homology_dims=(0,), top_k=5, min_persistence=0.1)):
        assert TopoRequest(field=mine, **kw).cache_key() == \
            JRequest(field=theirs, **kw).cache_key()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_request_key_of_arrays_and_tensors_matches_reference(dtype):
    v = _vol().astype(dtype)
    want = J.request_key(JRequest(field=v))
    assert P.request_key(TopoRequest(field=v)) == want
    assert P.request_key(TopoRequest(field=torch.from_numpy(v))) == want
    assert P.fingerprint_array(v[:, ::2]) == J.fingerprint_array(v[:, ::2])
    # flat field + grid: the same key as its shaped spelling
    flat = TopoRequest(field=v.reshape(-1), grid=Grid.of(*DIMS))
    assert flat.cache_key() == JRequest(
        field=v.reshape(-1), grid=JG.Grid.of(*DIMS)).cache_key()
    # execution knobs and epsilon stay out of the key
    assert TopoRequest(field=v, backend="torch", epsilon=0.5).cache_key() \
        == want
    assert P.KEY_SCHEMA == J.KEY_SCHEMA


def test_unfingerprintable_fields_raise():
    anon = FunctionSource(lambda zlo, zhi: np.zeros((zhi - zlo, 4, 4),
                                                    np.float32), (4, 4, 4))
    with pytest.raises(P.CacheKeyError):
        TopoRequest(field=anon).cache_key()
    with pytest.raises(P.CacheKeyError):
        P.fingerprint_field(None)

    class Bare:
        dims = (4, 4, 4)

        def read_slab(self, zlo, zhi):
            return np.zeros((zhi - zlo, 4, 4), np.float32)

    with pytest.raises(P.CacheKeyError, match="no fingerprint"):
        P.fingerprint_field(Bare())


# --------------------------------------------------------------------------
# the store: one script, both packages
# --------------------------------------------------------------------------

def _store_script(mod):
    """A scripted run of a DiagramCache; returns every answer and the
    counters after each step."""
    out = []
    c = mod.DiagramCache(max_bytes=100)
    steps = [
        ("put", ("k",), b"coarse", 0.5, 2), ("get", ("k",), 0.1),
        ("get", ("k",), 0.5), ("put", ("k",), b"same", 0.5, 2),
        ("put", ("k",), b"loose", 0.9, 3), ("put", ("k",), b"tight", 0.1, 1),
        ("put", ("k",), b"e" * 30, 0.0, 0), ("get", ("k",), 0.0),
        ("put", ("a",), b"x" * 40, 0.0, 0), ("get", ("a",), 0.0),
        ("put", ("b",), b"y" * 40, 0.0, 0), ("get", ("k",), 1.0),
        ("put", ("big",), b"z" * 101, 0.0, 0), ("get", ("zz",), 1.0),
    ]
    for st in steps:
        if st[0] == "put":
            out.append(c.put(st[1], st[2], error_bound=st[3], level=st[4]))
        else:
            e = c.get(st[1], epsilon=st[2])
            out.append(None if e is None else
                       (e.payload, e.error_bound, e.level, e.hits,
                        e.upgrades, e.exact, e.nbytes))
        out.append((c.stats(), c.bytes, len(c),
                    sorted(k for k in (("k",), ("a",), ("b",)) if k in c)))
    pk = c.peek(("b",))
    out.append(None if pk is None else pk.payload)
    for bad in (lambda: c.get(("k",), epsilon=-1.0),
                lambda: c.put(("k",), "not bytes"),
                lambda: c.put(("k",), b"x", error_bound=-1.0),
                lambda: mod.DiagramCache(max_bytes=0)):
        with pytest.raises((ValueError, TypeError)) as ei:
            bad()
        out.append(type(ei.value).__name__)
    c.clear()
    out.append((len(c), c.bytes))
    return out


def test_diagram_cache_matches_reference():
    assert _store_script(P) == _store_script(J)


# --------------------------------------------------------------------------
# admission
# --------------------------------------------------------------------------

def _admission_script(mod):
    out = []
    for kw in (dict(degrade_depth=4, shed_depth=8),
               dict(degrade_depth=None, shed_depth=None,
                    degrade_latency_s=0.5), {}):
        p = mod.AdmissionPolicy(**kw)
        out.append([p.decide(d, p99_latency_s=lat)
                    for d in (0, 3, 4, 8, 100) for lat in (None, 0.4, 0.6)])
    e = mod.AdmissionPolicy(shed_depth=10, retry_after_s=0.1) \
        .overload_error(30)
    out.append((type(e).__name__, e.queue_depth, e.retry_after_s, str(e)))
    for bad in (dict(degrade_depth=8, shed_depth=4), dict(degrade_frac=0.0),
                dict(retry_after_s=0.0), dict(degrade_depth=-1)):
        with pytest.raises(ValueError):
            mod.AdmissionPolicy(**bad)
    out.append((mod.ACCEPT, mod.DEGRADE, mod.SHED))
    return out


def test_admission_policy_matches_reference():
    assert _admission_script(P) == _admission_script(J)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_degrade_request_matches_reference(dtype):
    v = _vol("isabel").astype(dtype)
    pol, jpol = P.AdmissionPolicy(degrade_frac=0.1), \
        J.AdmissionPolicy(degrade_frac=0.1)
    jreq, jdid = J.degrade_request(JRequest(field=v), jpol)
    assert jdid
    for field in (v, torch.from_numpy(v)):
        req, did = P.degrade_request(TopoRequest(field=field), pol)
        assert did and req.epsilon == jreq.epsilon
    base = TopoRequest(field=torch.from_numpy(v))
    for spared in (base.replace(epsilon=0.2), base.replace(deadline_s=1.0),
                   base.replace(progressive=True),
                   TopoRequest(field=torch.zeros(4, 4, 4)),
                   TopoRequest(field=np.zeros((4, 4, 4))),
                   TopoRequest(field=FunctionSource.synthetic("wavelet",
                                                              DIMS))):
        out, did = P.degrade_request(spared, pol)
        assert not did and out is spared
