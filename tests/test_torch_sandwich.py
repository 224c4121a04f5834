"""PyTorch port, sandwich back-end: each phase fed exactly the JAX
package's gradient and critical info (carried across as numpy) and held
bit for bit against ``repro.kernels.sandwich`` — critical extraction, D0,
the dual graph (every terminal strategy), D1 on both branches (host burst
and batched wavefront, every batch size) — plus the
positive-highest-edge invariant."""

import numpy as np
import pytest
import torch

from repro.core import grid as JG
from repro.core.extremum_graph import build_d0_graph as j_build_d0
from repro.core.gradient import compute_gradient
from repro.core.saddle_saddle import pair_saddle_saddle_seq
from repro.fields.generators import make_field
from repro.kernels import sandwich as JS

from repro_torch.core.critical import CriticalInfo
from repro_torch.core.extremum_graph import build_d0_graph
from repro_torch.core.gradient import gradient_from_numpy
from repro_torch.core.grid import Grid
from repro_torch.kernels import sandwich as S
from repro_torch.obs.metrics import global_metrics
from repro_torch.pipeline import PersistencePipeline, TopoRequest

ZOO = ["wavelet", "random", "elevation", "magnetic"]
GRIDS = [(8, 8, 8), (5, 9, 3)]
CASES = pytest.mark.parametrize(
    "name,dims", [(n, d) for d in GRIDS + [(12, 10, 1)] for n in ZOO])


def _inputs(name, dims, seed=3):
    """Reference gradient/critical info of one field, and the same carried
    across into the port."""
    jg, g = JG.Grid.of(*dims), Grid.of(*dims)
    f = make_field(name, dims, seed=seed)
    order = np.asarray(JG.vertex_order(f))
    jgf = compute_gradient(jg, order, backend="jax")
    jci = JS.extract_critical_kernel(jg, jgf, order)
    gf = gradient_from_numpy(g, jgf.pair_up, jgf.pair_down, jgf.crit, "cpu")
    ci = CriticalInfo.from_numpy(g, order, jci.crit_sids, jci.ranks, "cpu")
    return jg, g, order, jgf, jci, gf, ci


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def _pairs(p):
    return [tuple(x) for x in p.tolist()]


def _d1_sets(jg, jgf, jci):
    """(c1, c2) of the reference: critical edges not D0-paired, critical
    triangles not paired in the dual diagram."""
    p0 = JS.pair_extrema_saddles_kernel(j_build_d0(jg, jgf, jci))
    pD = JS.pair_extrema_saddles_kernel(
        JS.build_dual_graph_chase(jg, jgf, jci, jci.crit_sids[2]))
    d0s, dps = {s for s, _ in p0.pairs}, {s for s, _ in pD.pairs}
    c1 = np.asarray([e for e in jci.crit_sids[1] if e not in d0s], np.int64)
    c2 = np.asarray([s for s in jci.crit_sids[2] if s not in dps], np.int64)
    return c1, c2


@pytest.mark.parametrize("dims", GRIDS + [(12, 10, 1)])
@pytest.mark.parametrize("name", ZOO)
def test_sandwich_phases_match_reference(name, dims):
    jg, g, order, jgf, jci, gf, ci = _inputs(name, dims)

    # critical extraction (from the carried gradient and the order)
    mine = S.extract_critical_kernel(g, gf, torch.from_numpy(order))
    for k in jci.crit_sids:
        np.testing.assert_array_equal(mine.crit_sids[k].numpy(),
                                      jci.crit_sids[k], err_msg=f"crit {k}")
        np.testing.assert_array_equal(mine.ranks[k].numpy(), jci.ranks[k],
                                      err_msg=f"ranks {k}")

    # D0: graph and pairs
    jg0 = j_build_d0(jg, jgf, jci)
    g0 = build_d0_graph(g, gf, ci)
    for a in ("saddles", "t0", "t1", "ext_key"):
        np.testing.assert_array_equal(getattr(g0, a).numpy(),
                                      getattr(jg0, a), err_msg=a)
    jp0, p0 = JS.pair_extrema_saddles_kernel(jg0), \
        S.pair_extrema_saddles_kernel(g0)
    assert p0.pairs == jp0.pairs
    assert p0.unpaired.tolist() == jp0.unpaired

    d = g.dim
    if d < 2:
        return
    # dual graph: every terminal strategy, then its pairs
    sad = jci.crit_sids[d - 1] if d == 3 else np.asarray(
        [e for e in jci.crit_sids[1] if e not in {s for s, _ in jp0.pairs}],
        np.int64)
    jgd = JS.build_dual_graph_chase(jg, jgf, jci, sad)
    for strategy in ("auto", "lazy", "chase", "doubling"):
        gd = S.build_dual_graph_chase(g, gf, ci, _t(sad), strategy=strategy)
        for a in ("saddles", "t0", "t1", "ext_key"):
            np.testing.assert_array_equal(getattr(gd, a).numpy(),
                                          getattr(jgd, a),
                                          err_msg=f"{strategy} {a}")
    jpd = JS.pair_extrema_saddles_kernel(jgd)
    pd = S.pair_extrema_saddles_kernel(gd)
    assert pd.pairs == jpd.pairs and pd.unpaired.tolist() == jpd.unpaired

    if d < 3:
        return
    # D1: host burst branch (default here) and the batched wavefront
    c1, c2 = _d1_sets(jg, jgf, jci)
    want = JS.pair_saddle_saddle_wavefront(jg, jgf, jci, c1, c2)
    for kw in ({}, {"burst_below": 0, "batch": 64}):
        got = S.pair_saddle_saddle_wavefront(g, gf, ci, _t(c1), _t(c2), **kw)
        assert _pairs(got.pairs) == want.pairs, kw
        assert got.unpaired_edges.tolist() == want.unpaired_edges, kw
        assert got.unpaired_triangles.tolist() == want.unpaired_triangles, kw


@pytest.mark.parametrize("batch", [1, 7, 4096])
def test_wavefront_rounds_and_expansions_match_reference(batch):
    """Batched path, same batch: same pairs, same counters."""
    jg, g, order, jgf, jci, gf, ci = _inputs("random", (10, 11, 9), seed=2)
    c1, c2 = _d1_sets(jg, jgf, jci)
    want = JS.pair_saddle_saddle_wavefront(jg, jgf, jci, c1, c2, batch=batch,
                                           burst_below=0)
    got = S.pair_saddle_saddle_wavefront(g, gf, ci, _t(c1), _t(c2),
                                         batch=batch, burst_below=0)
    assert _pairs(got.pairs) == want.pairs
    assert got.unpaired_edges.tolist() == want.unpaired_edges
    assert got.unpaired_triangles.tolist() == want.unpaired_triangles
    assert (got.expansions, got.rounds) == (want.expansions, want.rounds)


@pytest.mark.parametrize("batch", [2, S.CUDA_BATCH])
def test_wavefront_any_batch_gives_the_sequential_pairs(batch):
    """The batch size (the GPU default holds every column in one batch)
    changes the rounds, never the pairs of the sequential reduction."""
    jg, g, order, jgf, jci, gf, ci = _inputs("random", (10, 11, 9), seed=2)
    c1, c2 = _d1_sets(jg, jgf, jci)
    seq = pair_saddle_saddle_seq(jg, jgf, jci, c1, c2)
    got = S.pair_saddle_saddle_wavefront(g, gf, ci, _t(c1), _t(c2),
                                         batch=batch, burst_below=0)
    assert sorted(_pairs(got.pairs)) == sorted(seq.pairs)
    assert got.unpaired_edges.tolist() == seq.unpaired_edges
    assert got.unpaired_triangles.tolist() == seq.unpaired_triangles


def test_wavefront_invariant_raises_on_corrupted_gradient():
    jg, g, order, jgf, jci, gf, ci = _inputs("random", (6, 6, 6), seed=0)
    c1, c2 = _d1_sets(jg, jgf, jci)
    ok = S.pair_saddle_saddle_wavefront(g, gf, ci, _t(c1), _t(c2))
    assert len(ok.pairs), "expected at least one saddle-saddle pair"
    birth = int(ok.pairs[0, 0])
    # drop a known birth edge from the critical set: propagation then
    # reaches an edge that is neither paired upward nor claimable
    c1_bad = _t([e for e in c1 if int(e) != birth])
    for burst_below in (10 ** 9, 0):
        with pytest.raises(S.GradientInvariantError, match="positive"):
            S.pair_saddle_saddle_wavefront(g, gf, ci, c1_bad, _t(c2),
                                           burst_below=burst_below)


def test_critical_info_carry_across_roundtrip():
    jg, g, order, jgf, jci, gf, ci = _inputs("wavelet", (5, 4, 3))
    o, cs, rk = ci.to_numpy()
    np.testing.assert_array_equal(o, order)
    for k in jci.crit_sids:
        np.testing.assert_array_equal(cs[k], jci.crit_sids[k])
        np.testing.assert_array_equal(rk[k], jci.ranks[k])


def test_extract_rank_compresses_wide_keys():
    """Full-width int64 keys (streamed fronts) are rank-compressed first."""
    jg, g, order, jgf, jci, gf, ci = _inputs("magnetic", (6, 5, 4))
    wide = order.astype(np.int64) * (1 << 33) + 12345
    want = JS.extract_critical_kernel(jg, jgf, wide)
    got = S.extract_critical_kernel(g, gf, torch.from_numpy(wide))
    for k in want.crit_sids:
        np.testing.assert_array_equal(got.crit_sids[k].numpy(),
                                      want.crit_sids[k])
        np.testing.assert_array_equal(got.ranks[k].numpy(), want.ranks[k])


# --------------------------------------------------------------------------
# The dense edge keys, built only when a stage reads ``ranks[1]``
# --------------------------------------------------------------------------

def _dense_builds():
    return global_metrics().counter("pairing.dense_edge_keys").value


@CASES
def test_deferred_edge_keys_match_reference(name, dims):
    """``ranks[1]`` read through ``[]``, ``items()``, ``values()``,
    ``to_numpy()`` and a ``from_numpy`` round trip is the reference's dense
    key array, built once on the first read; ``in``, ``len`` and iteration
    build nothing."""
    jg, g, order, jgf, jci, gf, ci = _inputs(name, dims)
    before = _dense_builds()
    mine = S.extract_critical_kernel(g, gf, torch.from_numpy(order))
    assert 1 in mine.ranks and 9 not in mine.ranks
    assert list(mine.ranks) == sorted(jci.ranks) and \
        len(mine.ranks) == len(jci.ranks)
    assert _dense_builds() == before
    first = mine.ranks[1]
    assert _dense_builds() == before + 1
    np.testing.assert_array_equal(first.numpy(), jci.ranks[1])
    assert mine.ranks[1] is first
    assert any(v is first for v in mine.ranks.values())
    items = dict(mine.ranks.items())
    assert sorted(items) == sorted(jci.ranks)
    for k, v in items.items():
        np.testing.assert_array_equal(v.numpy(), jci.ranks[k], err_msg=k)
    o, cs, rk = mine.to_numpy()
    np.testing.assert_array_equal(rk[1], jci.ranks[1])
    back = CriticalInfo.from_numpy(g, o, cs, rk, "cpu")
    for k in jci.ranks:
        np.testing.assert_array_equal(back.ranks[k].numpy(), jci.ranks[k])
        np.testing.assert_array_equal(back.crit_sids[k].numpy(),
                                      jci.crit_sids[k])
    assert _dense_builds() == before + 1


@CASES
def test_d0_builds_no_dense_edge_keys(name, dims):
    """Extraction, the D0 graph and its pairing never read ``ranks[1]``,
    and give the reference's critical cells and D0 pairs."""
    jg, g, order, jgf, jci, gf, ci = _inputs(name, dims)
    before = _dense_builds()
    mine = S.extract_critical_kernel(g, gf, torch.from_numpy(order))
    for k in jci.crit_sids:
        np.testing.assert_array_equal(mine.crit_sids[k].numpy(),
                                      jci.crit_sids[k], err_msg=f"crit {k}")
    p0 = S.pair_extrema_saddles_kernel(build_d0_graph(g, gf, mine))
    jp0 = JS.pair_extrema_saddles_kernel(j_build_d0(jg, jgf, jci))
    assert p0.pairs == jp0.pairs
    assert p0.unpaired.tolist() == jp0.unpaired
    assert _dense_builds() == before


@CASES
def test_pipeline_builds_dense_edge_keys_only_for_full_diagrams(name, dims):
    """Through the pipeline's ``torch`` sandwich back-end a D0-only request
    builds no dense edge keys and a full one builds them once; both give
    the ``np`` back-end's diagram."""
    f = make_field(name, dims, seed=3)
    grid = Grid.of(*dims)
    torch_pipe = PersistencePipeline(device="cpu")
    np_pipe = PersistencePipeline(device="cpu", sandwich_backend="np")
    for hdims, builds in (((0,), 0), (None, 1)):
        req = TopoRequest(field=f, grid=grid, homology_dims=hdims)
        before = _dense_builds()
        got = torch_pipe.run(req)
        assert _dense_builds() - before == builds, hdims
        assert got.to_bytes() == np_pipe.run(req).to_bytes(), hdims


@CASES
def test_wide_keys_defer_the_compressed_edge_keys(name, dims):
    """Full-width int64 keys: the critical edges are keyed, and the
    deferred dense keys built, from the rank-compressed order."""
    jg, g, order, jgf, jci, gf, ci = _inputs(name, dims)
    wide = order.astype(np.int64) * (1 << 33) + 12345
    want = JS.extract_critical_kernel(jg, jgf, wide)
    before = _dense_builds()
    got = S.extract_critical_kernel(g, gf, torch.from_numpy(wide))
    for k in want.crit_sids:
        np.testing.assert_array_equal(got.crit_sids[k].numpy(),
                                      want.crit_sids[k])
    assert _dense_builds() == before
    np.testing.assert_array_equal(got.ranks[1].numpy(), want.ranks[1])
    assert _dense_builds() == before + 1


@CASES
def test_critical_edge_keys_match_the_dense_keys(name, dims):
    """:func:`edge_keys_kernel` of any edge sids, the critical ones that
    extraction sorts by them included, gives the reference's dense key
    array at those sids: -1 on invalid and negative sids, and the same
    with an int32 order."""
    jg, g, order, jgf, jci, gf, ci = _inputs(name, dims)
    o = torch.from_numpy(order)
    ref = torch.from_numpy(jci.ranks[1])
    assert torch.equal(S.edge_keys_kernel(g, o), ref)
    every = torch.arange(g.sid_space(1))
    gen = torch.Generator().manual_seed(0)
    some = torch.cat([torch.randperm(g.sid_space(1), generator=gen)[:97],
                      torch.tensor([-1, -8])])
    cs = gf.critical_sids(1)
    for sids in (every, some, cs):
        want = torch.where(sids >= 0, ref[sids.clamp(min=0)], -1)
        assert torch.equal(S.edge_keys_kernel(g, o, sids), want)
        assert torch.equal(S.edge_keys_kernel(g, o.int(), sids), want)
