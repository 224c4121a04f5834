"""PyTorch port, approximation (``repro_torch.approx``) against the JAX
package's ``repro.approx`` on the CPU.

Same inputs, made from a seed with numpy, go through both packages; the
tolerance is 0 for every integer, bound and payload check:
``block_minmax`` against the reference's numpy and jax paths (odd dims,
2-D and 1-D grids, strides 1-8); hierarchy levels, dims and bounds, in
memory and from a source; ``approximate`` and ``refine`` payloads byte
for byte at every level over the field zoo; cross-decoding; the
bottleneck guarantee on the port's own results; the copied metrics; and
the request routing (epsilon, level 0, run_batch, plans)."""

import numpy as np
import pytest
import torch

from repro.approx import Hierarchy as JHierarchy
from repro.approx import approximate as j_approximate
from repro.approx import block_minmax as j_block_minmax
from repro.approx import refine as j_refine
from repro.approx.metrics import bottleneck_distance as j_bottleneck
from repro.approx.metrics import bottleneck_feasible as j_feasible
from repro.approx.metrics import essential_distance as j_essential
from repro.core import grid as JG
from repro.pipeline import DiagramResult as JResult
from repro.pipeline import PersistencePipeline as JPipeline
from repro.pipeline import TopoRequest as JRequest
from repro.stream import ArraySource as JArraySource

import repro_torch.approx.engine as eng
from repro_torch.approx.hierarchy import cascade_minmax
from repro_torch.approx import (APPROX_META, Hierarchy, approximate,
                                block_minmax, bottleneck_distance,
                                bottleneck_feasible, coarse_dims,
                                essential_distance, refine)
from repro_torch.core.grid import Grid
from repro_torch.fields.generators import make_field
from repro_torch.pipeline import DiagramResult, PersistencePipeline, TopoRequest
from repro_torch.stream import ArraySource, DecimatedSource

DIMS = (12, 12, 12)
ZOO = [("wavelet", DIMS), ("random", DIMS), ("isabel", DIMS),
       ("elevation", DIMS), ("truss", DIMS), ("magnetic", (16, 16))]
TOL = 1e-9


@pytest.fixture(scope="module")
def pipe():
    return PersistencePipeline(device="cpu")


@pytest.fixture(scope="module")
def jpipe():
    return JPipeline(backend="jax")


def _reqs(name, dims, seed=0, **kw):
    f = make_field(name, dims, seed=seed)
    return (TopoRequest(field=f, grid=Grid.of(*dims), **kw),
            JRequest(field=f, grid=JG.Grid.of(*dims), **kw))


def _levels_of(levels):
    return [(lv.level, lv.stride, tuple(lv.dims), lv.bound)
            for lv in levels]


def _levels(h):
    return _levels_of(h.levels)


# --------------------------------------------------------------------------
# block_minmax and the hierarchy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 5, 9), (1, 6, 11), (1, 1, 13),
                                   (8, 8, 8), (3, 10, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_minmax_matches_reference(shape, dtype):
    vol = np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(dtype)
    # the jax path compiles one program per shape and stride: float32
    # (the dtype fields have) goes through both paths, float64 through np
    backends = ("np", "jax") if dtype == np.float32 else ("np",)
    for s in range(1, 9):
        mn, mx = block_minmax(torch.from_numpy(vol), s)
        for backend in backends:
            jmn, jmx = j_block_minmax(vol, s, backend)
            assert mn.numpy().dtype == jmn.dtype, (s, backend)
            np.testing.assert_array_equal(mn.numpy(), jmn)
            np.testing.assert_array_equal(mx.numpy(), jmx)
        # numpy input: same answer on the requested device
        mn2, _ = block_minmax(vol, s, device="cpu")
        assert torch.equal(mn2, mn)
    with pytest.raises(ValueError, match="stride"):
        block_minmax(vol, 0)


@pytest.mark.parametrize("name,dims", ZOO + [("random", (13, 7, 5)),
                                             ("wavelet", (9, 1, 1))])
def test_hierarchy_matches_reference(name, dims):
    f = make_field(name, dims, seed=1)
    g, jg = Grid.of(*dims), JG.Grid.of(*dims)
    h = Hierarchy(f, g, device="cpu")
    jh = JHierarchy(f, jg, backend="jax")
    assert _levels(h) == _levels(jh)
    assert all(lv.dims == coarse_dims(dims, lv.stride) for lv in h.levels)
    for lv in h.levels:
        np.testing.assert_array_equal(h.error_field(lv.level).numpy(),
                                      jh.error_field(lv.level))
        dec = h.decimate(lv.level)
        assert isinstance(dec, torch.Tensor) and dec.is_contiguous()
        np.testing.assert_array_equal(dec.numpy(),
                                      jh.decimate(lv.level))
    for eps in (0.0, h.levels[-1].bound, 1e9,
                h.levels[min(1, h.max_level)].bound + 1e-6):
        assert _levels_of([h.pick_level(eps)]) == \
            _levels_of([jh.pick_level(eps)])


@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 7, 5), (1, 1, 37)])
def test_cascade_equals_direct_block_passes(shape):
    vol = torch.from_numpy(
        np.random.default_rng(5).standard_normal(shape).astype(np.float32))
    top = 3
    mins, maxs = cascade_minmax(*block_minmax(vol, 2), top)
    assert sorted(mins) == sorted(maxs) == [1, 2, 3]
    for l in range(1, top + 1):
        mn, mx = block_minmax(vol, 2 ** l)
        assert torch.equal(mins[l], mn) and torch.equal(maxs[l], mx)


def test_given_hierarchy_field_is_reused(pipe, monkeypatch):
    req, _ = _reqs("isabel", DIMS, seed=4)
    h = Hierarchy(req.field, req.grid, device="cpu")
    copies = []
    real = eng.as_tensor
    monkeypatch.setattr(eng, "as_tensor",
                        lambda *a, **k: copies.append(1) or real(*a, **k))
    got = [approximate(pipe, req, level=l, hierarchy=h)
           for l in range(h.max_level + 1)]
    assert [(a.approx_level, a.error_bound) for a in got] == \
        [(lv.level, lv.bound) for lv in h.levels]
    walk = list(refine(pipe, req, hierarchy=h))
    assert walk[-1].to_bytes() == got[0].to_bytes() and not copies
    approximate(pipe, req, level=1)
    assert copies == [1]


def test_hierarchy_from_source_matches_reference():
    dims = (10, 9, 12)
    v = make_field("random", dims, seed=4).reshape(dims[::-1])
    h = Hierarchy(ArraySource(v))
    jh = JHierarchy(JArraySource(v))
    assert _levels(h) == _levels(jh) == _levels(Hierarchy(v))
    dec = h.decimate(1)
    assert isinstance(dec, DecimatedSource) and dec.dims == h.levels[1].dims
    np.testing.assert_array_equal(dec.read_slab(0, dec.dims[2]),
                                  jh.decimate(1).read_slab(0, dec.dims[2]))


# --------------------------------------------------------------------------
# approximate / refine: payloads byte for byte, and the guarantee
# --------------------------------------------------------------------------

def _assert_guarantee(res, exact, dims):
    bound = res.error_bound + TOL
    for p in range(len(dims)):
        assert bottleneck_feasible(res.pairs(p, min_persistence=0),
                                   exact.pairs(p, min_persistence=0),
                                   bound), f"dim {p} exceeds {bound}"
        assert essential_distance(res.essential(p),
                                  exact.essential(p)) <= bound


@pytest.mark.parametrize("name,dims", ZOO)
def test_approximate_payloads_match_reference(pipe, jpipe, name, dims):
    req, jreq = _reqs(name, dims)
    exact = pipe.run(req)
    h = Hierarchy(req.field, req.grid)
    assert h.max_level >= 2
    for lv in h.levels:
        res = approximate(pipe, req, level=lv.level, hierarchy=h)
        want = j_approximate(jpipe, jreq, level=lv.level)
        assert res.to_bytes() == want.to_bytes(), (name, lv.level)
        assert (res.error_bound, res.approx_level, res.approx_stride) == \
            (lv.bound, lv.level, lv.stride)
        assert res.grid_dims == lv.dims
        _assert_guarantee(res, exact, dims)
        # each package decodes the other's payload the same way
        mine, theirs = DiagramResult.from_bytes(want.to_bytes()), \
            JResult.from_bytes(res.to_bytes())
        for a, b in ((mine, want), (theirs, res)):
            assert (a.error_bound, a.approx_level, a.approx_stride,
                    a.uncertainty_threshold) == \
                (b.error_bound, b.approx_level, b.approx_stride,
                 b.uncertainty_threshold)
            for p in range(len(dims)):
                np.testing.assert_array_equal(
                    a.pairs(p, certain_only=True),
                    b.pairs(p, certain_only=True))


@pytest.mark.parametrize("name,dims", ZOO)
def test_refine_matches_reference(pipe, jpipe, name, dims):
    req, jreq = _reqs(name, dims, seed=2)
    got = list(refine(pipe, req))
    want = list(j_refine(jpipe, jreq))
    assert [(r.approx_level, r.error_bound) for r in got] == \
        [(r.approx_level, r.error_bound) for r in want]
    bounds = [r.error_bound for r in got]
    assert bounds == sorted(bounds, reverse=True) and bounds[-1] == 0.0
    for a, b in zip(got, want):
        assert a.to_bytes() == b.to_bytes()
    # the drained walk is the progressive run, and the exact diagram
    # plus its guarantee stamp
    prog = pipe.run(req.replace(progressive=True))
    assert got[-1].to_bytes() == prog.to_bytes()
    exact = pipe.run(req).arrays()
    last = dict(got[-1].arrays())
    assert last.pop(APPROX_META).tolist() == \
        [0.0, 0, 1] + list(req.grid.dims)
    assert sorted(last) == sorted(exact)
    for k in exact:
        np.testing.assert_array_equal(last[k], exact[k])


def test_refine_stopping_rules_match_reference(pipe, jpipe):
    req, jreq = _reqs("wavelet", DIMS)
    h = Hierarchy(req.field, req.grid)
    eps = h.bound(2) + 1e-6
    got = list(refine(pipe, req, epsilon=eps))
    want = list(j_refine(jpipe, jreq, epsilon=eps))
    assert [r.approx_level for r in got] == [r.approx_level for r in want]
    assert got[-1].approx_level == 2
    got = list(refine(pipe, req, deadline_s=1e-9))
    assert [r.approx_level for r in got] == [h.max_level]
    # a constant field: every level is exact, so coarsest + final only
    const = TopoRequest(field=np.zeros(Grid.of(*DIMS).nv, np.float32),
                        grid=Grid.of(*DIMS))
    assert [r.error_bound for r in refine(pipe, const)] == [0.0, 0.0]


def test_streamed_source_approximation_matches_reference(pipe, jpipe):
    dims = (10, 10, 12)
    v = make_field("random", dims, seed=4).reshape(dims[::-1])
    res = approximate(pipe, TopoRequest(field=ArraySource(v), chunk_z=4),
                      level=1)
    want = j_approximate(jpipe, JRequest(field=JArraySource(v), chunk_z=4),
                         level=1)
    assert res.stream is not None
    assert res.to_bytes() == want.to_bytes()
    mem = approximate(pipe, TopoRequest(field=v), level=1)
    assert res.to_bytes() == mem.to_bytes()


# --------------------------------------------------------------------------
# routing through the pipeline
# --------------------------------------------------------------------------

def test_epsilon_routing_matches_reference(pipe, jpipe):
    req, jreq = _reqs("isabel", DIMS, seed=1)
    h = Hierarchy(req.field, req.grid)
    for eps in (h.bound(1) + 1e-6, h.bound(h.max_level), 1e9, 0.0, 1e-9):
        got = pipe.run(req.replace(epsilon=eps))
        want = jpipe.run(jreq.replace(epsilon=eps))
        assert got.to_bytes() == want.to_bytes(), eps
        assert got.error_bound <= eps
    with pytest.raises(ValueError, match="epsilon= or level="):
        approximate(pipe, req)
    with pytest.raises(ValueError, match="not both"):
        approximate(pipe, req, epsilon=0.1, level=1)
    with pytest.raises(ValueError, match="epsilon"):
        TopoRequest(field=np.zeros(8), epsilon=-0.5)
    with pytest.raises(ValueError, match="deadline_s"):
        TopoRequest(field=np.zeros(8), deadline_s=0.0)


@pytest.mark.parametrize("kw,builds", [
    (dict(level=0), False), (dict(epsilon=1e-9), False),
    (dict(epsilon=0.0), False), (dict(epsilon=1e9), True)])
def test_level_zero_short_cut(pipe, monkeypatch, kw, builds):
    calls = []
    real = eng.Hierarchy
    monkeypatch.setattr(eng, "Hierarchy",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    req, _ = _reqs("random", DIMS, seed=3)
    res = approximate(pipe, req, **kw)
    assert bool(calls) == builds
    if not builds:
        assert res.approx_level == 0 and res.error_bound == 0.0
        exact = pipe.run(req).arrays()
        for k, a in exact.items():
            np.testing.assert_array_equal(res.arrays()[k], a)


def test_run_batch_and_plan_are_approximation_aware(pipe, jpipe):
    req, jreq = _reqs("isabel", DIMS, seed=2)
    kws = [{}, dict(epsilon=10.0), dict(progressive=True),
           dict(deadline_s=1e3), dict(epsilon=10.0, top_k=3)]
    got = pipe.run_batch([req.replace(**k) for k in kws])
    want = jpipe.run_batch([jreq.replace(**k) for k in kws])
    for a, b in zip(got, want):
        assert a.to_bytes() == b.to_bytes()
    assert got[0].error_bound is None and got[2].error_bound == 0.0
    assert len(got[4].pairs(0)) <= 3 and got[4].request.epsilon == 10.0
    plan = pipe.lower(req.replace(epsilon=0.25, progressive=True))
    assert plan.is_approx and plan.epsilon == 0.25 and plan.progressive
    assert "approx(epsilon=0.25, progressive" in plan.describe()
    assert plan.key != pipe.lower(req).key


def test_certain_only(pipe):
    req, _ = _reqs("random", DIMS)
    res = approximate(pipe, req, level=1)
    thr = res.uncertainty_threshold
    assert thr == 2 * res.error_bound
    certain = res.pairs(0, certain_only=True)
    assert len(certain) <= len(res.pairs(0, min_persistence=0))
    assert (certain[:, 1] - certain[:, 0] > thr).all()
    with pytest.raises(ValueError, match="value-space"):
        res.pairs(0, space="order", certain_only=True)
    exact = pipe.run(req)
    assert exact.error_bound is None
    np.testing.assert_array_equal(exact.pairs(0, certain_only=True),
                                  exact.pairs(0))


# --------------------------------------------------------------------------
# the copied bottleneck metrics
# --------------------------------------------------------------------------

def _diagram(rng, n):
    b = rng.standard_normal(n)
    return np.stack([b, b + rng.exponential(0.5, n)], axis=1)


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = _diagram(rng, 12 + seed), _diagram(rng, 9)
    d = bottleneck_distance(a, b)
    assert d == j_bottleneck(a, b)
    for x in (d, d * 0.999, d * 0.5, 0.0, 10.0):
        assert bottleneck_feasible(a, b, x) == j_feasible(a, b, x)
    assert bottleneck_feasible(a, b, d) and not bottleneck_feasible(
        a, b, d * 0.999)
    ea, eb = rng.standard_normal(3), rng.standard_normal(3)
    assert essential_distance(ea, eb) == j_essential(ea, eb)
    assert essential_distance(ea, eb[:2]) == float("inf")
    assert bottleneck_distance(a, a) == 0.0
    with pytest.raises(ValueError, match="finite"):
        bottleneck_distance([[0.0, np.inf]], a)
