"""PyTorch port, the numpy oracles: literal Robins (``compute_gradient_np``,
both forms), the reference sandwich phases (``extract_critical``,
``build_dual_graph``, ``pair_extrema_saddles``,
``pair_saddle_saddle_seq``) and the boundary-matrix reduction
(``build_filtration``, ``reduce_standard`` / ``reduce_twist``,
``compute_oracle``), each against the JAX package's on the same numpy
inputs, bit for bit (tolerance 0: every result is an integer).  Then the
port's pipeline under every mix of the ``np`` back-ends against the
reference's ``compute_dms`` and the port's own ``compute_oracle``, on
``tests/test_dms.py``'s cases and ``tests/test_reduction.py``'s fields,
in 1-D, 2-D and 3-D."""

import os
import sys

import numpy as np
import pytest
import torch

from repro.core import critical as JC
from repro.core import extremum_graph as JE
from repro.core import gradient as JGR
from repro.core import pairing as JP
from repro.core import reduction as JR
from repro.core import saddle_saddle as JS
from repro.core.diagram import diff_report as j_diff_report
from repro.core.dms import compute_dms as j_compute_dms
from repro.core.dms import oracle_to_diagram as j_oracle_to_diagram
from repro.core.grid import Grid as JGrid
from repro.core.grid import vertex_order as j_vertex_order
from repro.pipeline import PersistencePipeline as JPipeline

from repro_torch.core import critical as C
from repro_torch.core import extremum_graph as E
from repro_torch.core import gradient as GR
from repro_torch.core import pairing as P
from repro_torch.core import reduction as R
from repro_torch.core import saddle_saddle as S
from repro_torch.core.diagram import diff_report, same_offdiagonal
from repro_torch.core.dms import compute_dms, oracle_to_diagram
from repro_torch.core.grid import Grid, vertex_order
from repro_torch.kernels import ops
from repro_torch.pipeline import PersistencePipeline, TopoRequest

sys.path.insert(0, os.path.dirname(__file__))
from test_dms import CASES_1D, CASES_2D, CASES_3D  # noqa: E402

CASES = CASES_1D + CASES_2D + CASES_3D


def _field(dims, seed):
    """The random field ``tests/test_dms.py::_run`` makes."""
    return np.random.default_rng(seed).standard_normal(Grid.of(*dims).nv)


def _elevation(dims):
    """``tests/test_reduction.py``'s elevation field x + 10 y + 100 z."""
    g = Grid.of(*dims)
    v = np.arange(g.nv)
    nx, ny, _ = g.dims
    return ((v % nx) + 10 * ((v // nx) % ny) + 100 * (v // (nx * ny))
            ).astype(np.float64)


def _wavelet_like():
    """``tests/test_dms.py::test_dms_wavelet_like``'s smooth field."""
    x, y, z = np.meshgrid(np.linspace(-2, 2, 8), np.linspace(-2, 2, 8),
                          np.linspace(-2, 2, 4), indexing="ij")
    f3 = np.cos(3 * x) * np.cos(2 * y) * np.cos(2 * z) * np.exp(
        -(x ** 2 + y ** 2 + z ** 2) / 4)
    return np.transpose(f3, (2, 1, 0)).reshape(-1)


# tests/test_reduction.py's fields: (id, dims, field)
REDUCTION_FIELDS = (
    [(f"filtration-{s}", (3, 3, 2), _field((3, 3, 2), s)) for s in range(3)]
    + [(f"elevation-{len(d)}d", d, _elevation(d))
       for d in ((6,), (4, 4), (3, 3, 3))]
    + [(f"betti-{len(d)}d", d, _field(d, s))
       for d, s in (((8,), 0), ((5, 4), 1), ((3, 3, 3), 2))])

# every field of both files, for the whole-pipeline checks
ALL_FIELDS = ([(f"dms-{'x'.join(map(str, d))}-{s}", d, _field(d, s))
               for d, s in CASES]
              + [("dms-wavelet-8x8x4", (8, 8, 4), _wavelet_like())]
              + REDUCTION_FIELDS)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=what)


def _same_dict(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        _same(a[k], b[k], f"{what}[{k}]")


def _orders(dims, f):
    return (JGrid.of(*dims), np.asarray(j_vertex_order(f)), Grid.of(*dims),
            vertex_order(torch.from_numpy(f)))


# --------------------------------------------------------------------------
# literal Robins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["heapq", "masked"])
@pytest.mark.parametrize("dims,seed", CASES)
def test_gradient_np_matches_reference(dims, seed, masked):
    jg, jo, g, o = _orders(dims, _field(dims, seed))
    want = JGR.compute_gradient_np(jg, jo, masked=masked)
    got = GR.compute_gradient_np(g, o, masked=masked)
    for name, w in (("pair_up", want.pair_up), ("pair_down", want.pair_down),
                    ("crit", want.crit)):
        _same_dict(w, getattr(got, name), name)
    # the literal rows are the rows every kernel path writes
    rows = GR.lower_star_rows_np(g, o.numpy(), masked=masked)
    for a, b in zip(rows, ops.lower_star_gradient(g, o, "torch")):
        _same(a, b, "rows against the plain version")
    GR.check_gradient_valid(g, got, o)


def test_compute_gradient_dispatches_to_the_kernels():
    dims = (5, 4, 3)
    _, _, g, o = _orders(dims, _field(dims, 1))
    want = GR.compute_gradient_np(g, o)
    for backend in ops.BACKENDS:
        got = GR.compute_gradient(g, o, backend=backend)
        _same_dict(want.pair_up, got.pair_up, backend)
        _same_dict(want.crit, got.crit, backend)


# --------------------------------------------------------------------------
# the sandwich phases, one by one
# --------------------------------------------------------------------------

def _minus(a, b):
    b = {int(x) for x in b}
    return np.asarray([int(x) for x in a if int(x) not in b], np.int64)


@pytest.mark.parametrize("dims,seed", CASES)
def test_sandwich_phases_match_reference(dims, seed):
    jg, jo, g, o = _orders(dims, _field(dims, seed))
    jgf = JGR.compute_gradient_np(jg, jo)
    gf = GR.compute_gradient_np(g, o)

    jci = JC.extract_critical(jg, jgf, jo)
    ci = C.extract_critical(g, gf, o)
    _same_dict(jci.crit_sids, ci.crit_sids, "crit_sids")
    _same_dict(jci.ranks, ci.ranks, "ranks")
    for k in jci.crit_sids:
        _same(jci.max_vertex_order(k, jci.crit_sids[k]),
              ci.max_vertex_order(k, ci.crit_sids[k]), "max_vertex_order")
        _same(JC.simplex_ranks(jg, k, jo), C.simplex_ranks(g, k, o), "ranks")

    jp0 = JP.pair_extrema_saddles(JE.build_d0_graph(jg, jgf, jci))
    p0 = P.pair_extrema_saddles(E.build_d0_graph(g, gf, ci))
    assert p0.pairs == jp0.pairs and p0.unpaired.tolist() == jp0.unpaired
    d0_saddles = [s for s, _ in jp0.pairs]
    d = jg.dim
    if d < 2:
        return
    saddles = jci.crit_sids[d - 1] if d == 3 \
        else _minus(jci.crit_sids[1], d0_saddles)
    jgd = JE.build_dual_graph(jg, jgf, jci, saddles)
    gd = E.build_dual_graph(g, gf, ci, torch.from_numpy(saddles))
    for name in ("saddles", "t0", "t1", "ext_key"):
        _same(getattr(jgd, name), getattr(gd, name), f"dual {name}")
    jpd = JP.pair_extrema_saddles(jgd)
    pd = P.pair_extrema_saddles(gd)
    assert pd.pairs == jpd.pairs and pd.unpaired.tolist() == jpd.unpaired
    if d < 3:
        return
    c1 = _minus(jci.crit_sids[1], d0_saddles)
    c2 = _minus(jci.crit_sids[2], [s for s, _ in jpd.pairs])
    jss = JS.pair_saddle_saddle_seq(jg, jgf, jci, c1, c2)
    ss = S.pair_saddle_saddle_seq(g, gf, ci, torch.from_numpy(c1),
                                  torch.from_numpy(c2))
    assert [tuple(r) for r in ss.pairs.tolist()] == jss.pairs
    assert ss.unpaired_edges.tolist() == jss.unpaired_edges
    assert ss.unpaired_triangles.tolist() == jss.unpaired_triangles
    assert ss.expansions == jss.expansions and ss.rounds is None


def test_grid_star_queries_match_reference():
    for dims in ((4, 3, 5), (6, 4), (7,)):
        jg, g = JGrid.of(*dims), Grid.of(*dims)
        v = np.arange(jg.nv)
        for k in range(4):
            _same(jg.star_sids(k, v), g.star_sids(k, torch.from_numpy(v)),
                  "star_sids")
            (a, b), (c, e) = (jg.star_other_vertices(k, v),
                              g.star_other_vertices(k, torch.from_numpy(v)))
            _same(a, c, "star_other_vertices")
            _same(b, e, "star_other_vertices mask")
            _same(jg.all_valid_sids(k), g.all_valid_sids(k), "valid sids")


# --------------------------------------------------------------------------
# the boundary-matrix reduction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,dims,f", REDUCTION_FIELDS,
                         ids=[r[0] for r in REDUCTION_FIELDS])
def test_reduction_matches_reference(name, dims, f):
    jg, g = JGrid.of(*dims), Grid.of(*dims)
    jfilt, filt = JR.build_filtration(jg, f), R.build_filtration(g, f)
    assert filt.sims == jfilt.sims and filt.pos == jfilt.pos
    assert filt.n == jfilt.n
    _same(jfilt.order, filt.order, "filtration order")
    cols = JR._boundary_cols(jfilt)
    assert R._boundary_cols(filt) == cols
    dims_ = [k for k, _ in jfilt.sims]
    assert R.reduce_standard(cols) == JR.reduce_standard(cols)
    assert R.reduce_twist(cols, dims_, jg.dim) == \
        JR.reduce_twist(cols, dims_, jg.dim)
    assert R._add_mod2([1, 3, 4], [0, 3, 7]) == \
        JR._add_mod2([1, 3, 4], [0, 3, 7])
    for twist in (True, False):
        want = JR.compute_oracle(jg, f, twist=twist)
        got = R.compute_oracle(g, torch.from_numpy(f), twist=twist)
        assert got.pairs == want.pairs and got.essential == want.essential
        assert got.betti() == want.betti()
    jd, dg = j_oracle_to_diagram(want, jg), oracle_to_diagram(got, g)
    _same_dict(jd.pairs, dg.pairs, "oracle pairs")
    _same_dict(jd.essential, dg.essential, "oracle essential")
    assert dg.betti() == jd.betti()
    for p in range(jg.dim + 1):
        _same(jd.essential_orders(p), dg.essential_orders(p), "essential")
        if p < jg.dim:
            _same(jd.points_order(p), dg.points_order(p), "points_order")
            _same(jd.points_order(p, drop_diagonal=False),
                  dg.points_order(p, drop_diagonal=False), "points_order")
            _same(jd.points_value(p, f), dg.points_value(p, f),
                  "points_value")


# --------------------------------------------------------------------------
# whole pipeline under every mix of the np back-ends
# --------------------------------------------------------------------------

_REFERENCE = {}


def _reference(name, dims, f):
    """The reference's compute_dms and the port's oracle of one field."""
    if name not in _REFERENCE:
        _REFERENCE[name] = (j_compute_dms(JGrid.of(*dims), f).diagram,
                            oracle_to_diagram(R.compute_oracle(
                                Grid.of(*dims), f), Grid.of(*dims)))
    return _REFERENCE[name]


@pytest.mark.parametrize("backend,sandwich", [
    ("np", "np"), ("np", "torch"), ("torch", "np"), ("fused", "torch")])
@pytest.mark.parametrize("name,dims,f", ALL_FIELDS,
                         ids=[r[0] for r in ALL_FIELDS])
def test_pipeline_matches_reference_and_oracle(name, dims, f, backend,
                                               sandwich):
    want, orc = _reference(name, dims, f)
    res = PersistencePipeline(backend, sandwich_backend=sandwich,
                              device="cpu").run(
        TopoRequest(field=f, grid=Grid.of(*dims)))
    got = res.diagram
    _same_dict(want.pairs, got.pairs, "pairs")
    _same_dict(want.essential, got.essential, "essential")
    assert same_offdiagonal(got, orc), diff_report(got, orc)
    for p in range(Grid.of(*dims).dim + 1):
        _same(orc.essential_orders(p), got.essential_orders(p),
              f"essential[{p}]")
    assert diff_report(got, orc) == "diagrams equal"
    assert got.betti() == res.betti() == orc.betti()


@pytest.mark.parametrize("dims,seed", CASES)
def test_np_stage_counters_match_reference(dims, seed):
    f = _field(dims, seed)
    want = JPipeline("np", sandwich_backend="np").run(
        f, grid=JGrid.of(*dims)).stats
    got = PersistencePipeline("np", sandwich_backend="np",
                              device="cpu").run(f, grid=Grid.of(*dims)).stats
    for key in ("n_critical", "d1_expansions", "d1_rounds"):
        assert got.get(key) == want.get(key), key
    crit = JGR.compute_gradient_np(JGrid.of(*dims),
                                   np.asarray(j_vertex_order(f))).n_critical()
    assert {k: got[f"n_critical_d{k}"] for k in crit} == crit


def test_diagram_comparison_reports_differences():
    dims = (4, 4, 4)
    f = _field(dims, 0)
    g, jg = Grid.of(*dims), JGrid.of(*dims)
    orc = oracle_to_diagram(R.compute_oracle(g, f), g)
    jorc = j_oracle_to_diagram(JR.compute_oracle(jg, f), jg)
    res = compute_dms(g, f, gradient_backend="np", device="cpu").diagram
    assert same_offdiagonal(res, orc)
    # drop the most persistent D0 pair and one essential class
    pts = orc.points_order(0)
    keep = torch.ones(len(orc.pairs[0]), dtype=torch.bool)
    b, d = orc.pair_max_vertices(0)
    keep[torch.argmax(orc.order[d] - orc.order[b])] = False
    cut = type(orc)(g, orc.order, {**orc.pairs, 0: orc.pairs[0][keep]},
                    {**orc.essential, 0: orc.essential[0][:0]})
    jcut = type(jorc)(jg, jorc.order,
                      {**jorc.pairs, 0: jorc.pairs[0][keep.numpy()]},
                      {**jorc.essential, 0: jorc.essential[0][:0]})
    assert not same_offdiagonal(orc, cut) and same_offdiagonal(orc, cut,
                                                               dims=(1, 2))
    rep, jrep = diff_report(orc, cut, ("oracle", "cut")), \
        j_diff_report(jorc, jcut, ("oracle", "cut"))
    assert len(pts) == len(cut.points_order(0)) + 1
    assert rep.count("\n") == jrep.count("\n") == 1
    assert rep.startswith("D0: only oracle: [(") and \
        jrep.startswith("D0: only oracle: [(")
    assert "essential[0]: oracle=[0] cut=[]" in rep


def test_np_runs_only_when_named(monkeypatch):
    """The defaults are the kernels; a failing kernel raises, nothing
    falls back to the np back-ends."""
    pipe = PersistencePipeline(device="cpu")
    assert (pipe.backend.name, pipe.config.sandwich.name) == ("fused",
                                                              "torch")
    dims = (4, 3, 5)

    def broken(*a, **k):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(ops, "fused_lower_star_gradient", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        pipe.run(TopoRequest(field=_field(dims, 0), grid=Grid.of(*dims)))
