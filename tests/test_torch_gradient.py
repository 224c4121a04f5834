"""PyTorch port, front-end: tables, vertex order, the lower-star rows of
the plain version and of both kernel wrappers, and the GradientField
scatter — each held bit for bit against the JAX package on the CPU.

Inputs are made from seeded numpy and handed to both packages.  The fused
Pallas kernel does not build under the installed jax (``pl.Unblocked`` is
gone), so the rows are held against the pure-jnp oracle
``lower_star_gradient_jnp`` and the prepass Pallas kernel in interpret
mode.  The CUDA kernels are held against the plain version on a card
by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import gradient as JGR
from repro.core import grid as JG
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.lower_star import lower_star_gradient_pallas

from repro_torch.core import gradient as GR
from repro_torch.core import grid as G
from repro_torch.kernels import lower_star as LS
from repro_torch.kernels import ops, ref

# asymmetric dims + 1-thin slabs, 2-D and 1-D grids (tests/test_fused.py)
FUSED_DIMS = [(5, 3, 7), (4, 4, 4), (7, 5, 1), (1, 5, 6), (6, 1, 5),
              (2, 2, 2), (9, 4), (16,)]
NAMES = ("status", "partner", "vstat", "vpart")


def _orders(dims, seed=0):
    """(port grid, jax grid, int64 vertex order as numpy) of a seeded
    normal field."""
    g, jg = G.Grid.of(*dims), JG.Grid.of(*dims)
    f = np.random.default_rng(seed).standard_normal(g.nv).astype(np.float32)
    return g, jg, np.asarray(JG.vertex_order(f))


def _assert_rows(ref_rows, got_rows, tag):
    for a, b, name in zip(ref_rows, got_rows, NAMES):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(),
                                      err_msg=f"{tag} {name}")


def _assert_gf(jgf, gf, tag=""):
    pu, pd, cr = gf.to_numpy()
    for mine, theirs, name in ((pu, jgf.pair_up, "pair_up"),
                               (pd, jgf.pair_down, "pair_down"),
                               (cr, jgf.crit, "crit")):
        assert sorted(mine) == sorted(theirs), (tag, name)
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k],
                                          err_msg=f"{tag} {name}[{k}]")
            assert mine[k].dtype == theirs[k].dtype, (tag, name, k)


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["VERTS", "SPAN", "FACES", "COFACES", "STAR",
                                  "OTHERS", "STAR_FACES", "STAR_COFACES"])
def test_grid_tables_match_reference(name):
    mine, theirs = getattr(G, name), getattr(JG, name)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=f"{name}[{k}]")
        assert mine[k].dtype == theirs[k].dtype
    assert G.NTYPES == JG.NTYPES and G.NSTAR == JG.NSTAR and G.NCOF == JG.NCOF


def test_packed_tables_match_reference():
    assert GR.NROWS == JGR.NROWS and GR.ROW_OFF == JGR.ROW_OFF
    assert (GR.NOT_L, GR.AVAIL, GR.TAIL, GR.HEAD, GR.CRIT) == \
        (JGR.NOT_L, JGR.AVAIL, JGR.TAIL, JGR.HEAD, JGR.CRIT)
    assert sorted(GR.PACKED) == sorted(JGR.PACKED)
    for k, v in JGR.PACKED.items():
        np.testing.assert_array_equal(GR.PACKED[k], v, err_msg=k)
        assert GR.PACKED[k].dtype == v.dtype


@pytest.mark.parametrize("dims", [(5, 3, 7), (9, 4), (16,), (128, 64, 3)])
def test_row_sid_offsets_and_sid_dtype_match_reference(dims):
    g, jg = G.Grid.of(*dims), JG.Grid.of(*dims)
    mine, theirs = GR.row_sid_offsets(g), JGR.row_sid_offsets(jg)
    for k in theirs:
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k])
    for k in range(4):
        assert str(GR.sid_dtype(g, k)).split(".")[-1] == \
            np.dtype(JGR.sid_dtype(jg, k)).name


@pytest.mark.parametrize("dims", [(5, 3, 7), (7, 5, 1), (16,)])
def test_grid_queries_match_reference(dims):
    g, jg = G.Grid.of(*dims), JG.Grid.of(*dims)
    _, _, order = _orders(dims, seed=4)
    assert (g.nv, g.dim, g.strides) == (jg.nv, jg.dim, jg.strides)
    for k in range(g.dim + 1):
        assert g.n_simplices(k) == jg.n_simplices(k)
        sids = np.arange(g.sid_space(k), dtype=np.int64)
        ts = torch.from_numpy(sids)
        valid = np.asarray(jg.simplex_valid(k, sids))
        np.testing.assert_array_equal(g.simplex_valid(k, ts).numpy(), valid)
        vs = sids[valid]
        tv = torch.from_numpy(vs)
        np.testing.assert_array_equal(g.simplex_vertices(k, tv).numpy(),
                                      jg.simplex_vertices(k, vs))
        np.testing.assert_array_equal(
            g.simplex_key(k, tv, torch.from_numpy(order)).numpy(),
            jg.simplex_key(k, vs, order))
        np.testing.assert_array_equal(
            g.simplex_max_vertex(k, tv, torch.from_numpy(order)).numpy(),
            jg.simplex_max_vertex(k, vs, order))
        if k >= 1:
            np.testing.assert_array_equal(g.simplex_faces(k, tv).numpy(),
                                          jg.simplex_faces(k, vs))
        if k < g.dim:
            np.testing.assert_array_equal(g.simplex_cofaces(k, tv).numpy(),
                                          jg.simplex_cofaces(k, vs))


# --------------------------------------------------------------------------
# vertex order
# --------------------------------------------------------------------------

def test_vertex_order_ties_and_signed_zeros():
    rng = np.random.default_rng(7)
    f = rng.choice(np.array([-0.0, 0.0, 1.5, -2.0, 0.25], np.float32), 997)
    f[::13] = -0.0
    f[5::17] = 0.0
    for field in (f, f.astype(np.float64), f.reshape(997, 1)):
        got = G.vertex_order(torch.from_numpy(np.ascontiguousarray(field)))
        np.testing.assert_array_equal(got.numpy(), JG.vertex_order(field))
        assert got.dtype == torch.int64


def test_vertex_order_distinct_values():
    f = np.random.default_rng(8).standard_normal(5000).astype(np.float32)
    np.testing.assert_array_equal(G.vertex_order(torch.from_numpy(f)).numpy(),
                                  JG.vertex_order(f))


# --------------------------------------------------------------------------
# lower-star rows: plain version and wrappers vs the jnp oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims", FUSED_DIMS)
def test_plain_rows_match_jnp_oracle(dims):
    """Both key paths (packed below 2**21, columns with no bound — the
    path every grid from 128^3 up takes) and both rank widths, bit-equal
    to the oracle's jitted rows program (int32 ranks, packed keys)."""
    g, jg, order = _orders(dims)
    want = JOPS.lower_star_gradient(jg, order, backend="jax")
    nb = np.asarray(JOPS.neighbor_orders_jnp(jg, jnp.asarray(order)))
    for dtype in (torch.int32, torch.int64):
        to = torch.from_numpy(order).to(dtype)
        tnb = GR.neighbor_orders(g, to)
        np.testing.assert_array_equal(tnb.numpy(), nb)
        for rb in (g.nv, None):
            got = ref.lower_star_gradient_torch(tnb, to, rank_bound=rb)
            _assert_rows(want, got, (dims, dtype, rb))
            assert [t.dtype for t in got] == [torch.int8, torch.int8,
                                              torch.int8, torch.int32]


@pytest.mark.parametrize("dims", [(5, 3, 7), (1, 5, 6), (9, 4)])
def test_plain_column_path_matches_jnp_column_path(dims):
    """The rank-free int64 column path against the oracle's own."""
    g, jg, order = _orders(dims, seed=10)
    nb = JOPS.neighbor_orders_jnp(jg, jnp.asarray(order))
    want = JREF.lower_star_gradient_jnp(nb, jnp.asarray(order),
                                        rank_bound=None)
    to = torch.from_numpy(order)
    _assert_rows(want, ref.lower_star_gradient_torch(
        GR.neighbor_orders(g, to), to, rank_bound=None), dims)


@pytest.mark.parametrize("dims", FUSED_DIMS)
def test_wrappers_match_jnp_oracle(dims):
    """The fused and prepass wrappers (plain version on CPU tensors) and
    every ops backend give the oracle's rows."""
    g, jg, order = _orders(dims, seed=1)
    want = JOPS.lower_star_gradient(jg, order, backend="jax")
    to = torch.from_numpy(order)
    _assert_rows(want, LS.fused_lower_star_gradient(g, to), "fused")
    _assert_rows(want, LS.lower_star_gradient_prepass(
        GR.neighbor_orders(g, to), to, rank_bound=g.nv), "prepass")
    for be in ops.BACKENDS:
        _assert_rows(want, ops.lower_star_gradient(g, to, backend=be), be)


def test_plain_chunking_is_exact(monkeypatch):
    g, jg, order = _orders((6, 5, 4), seed=2)
    want = JOPS.lower_star_gradient(jg, order, backend="jax")
    monkeypatch.setattr(ref, "CHUNK", 17)
    to = torch.from_numpy(order)
    _assert_rows(want, ref.lower_star_gradient_torch(
        GR.neighbor_orders(g, to), to, rank_bound=g.nv), "chunked")


@pytest.mark.parametrize("dims", [(5, 3, 7), (7, 5, 1), (9, 4)])
def test_rows_match_prepass_pallas_interpret(dims):
    g, jg, order = _orders(dims, seed=3)
    nb = JOPS.neighbor_orders_jnp(jg, jnp.asarray(order))
    want = lower_star_gradient_pallas(nb, order, interpret=True,
                                      rank_bound=g.nv)
    to = torch.from_numpy(order)
    _assert_rows(want, LS.lower_star_gradient_prepass(
        GR.neighbor_orders(g, to), to, rank_bound=g.nv), dims)


def test_wrappers_reject_other_devices_and_shapes():
    g = G.Grid.of(3, 3, 3)
    with pytest.raises(ValueError):
        LS.fused_lower_star_gradient(g, torch.zeros(g.nv, dtype=torch.int64,
                                                    device="meta"))
    with pytest.raises(ValueError):
        LS.lower_star_gradient_prepass(torch.zeros((4, 26), dtype=torch.int32),
                                       torch.zeros(4, dtype=torch.int32))


# --------------------------------------------------------------------------
# GradientField
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(5, 3, 7), (7, 5, 1), (16,)])
def test_gradient_field_matches_compute_gradient(dims):
    g, jg, order = _orders(dims, seed=11)
    jgf = JGR.compute_gradient(jg, order, backend="jax")
    to = torch.from_numpy(order)
    [gf] = GR.scatter_results_batch(g, *ops.lower_star_gradient(g, to))
    _assert_gf(jgf, gf, dims)
    assert gf.n_critical() == jgf.n_critical()
    GR.check_gradient_valid(g, gf, to)
    assert GR.euler_characteristic(gf) == 1


def test_gradient_field_batch_of_three():
    g, jg = G.Grid.of(4, 3, 5), JG.Grid.of(4, 3, 5)
    rng = np.random.default_rng(13)
    orders = np.stack([np.asarray(JG.vertex_order(rng.standard_normal(g.nv)))
                       for _ in range(3)])
    rows = ops.rows_batch(g, torch.from_numpy(orders))
    gfs = GR.scatter_results_batch(g, *rows, B=3)
    for b in range(3):
        _assert_gf(JGR.compute_gradient(jg, orders[b], backend="jax"),
                   gfs[b], b)


def test_gradient_carry_across_roundtrip():
    g, jg, order = _orders((5, 4, 3), seed=5)
    jgf = JGR.compute_gradient(jg, order, backend="jax")
    gf = GR.gradient_from_numpy(g, jgf.pair_up, jgf.pair_down, jgf.crit,
                                "cpu")
    _assert_gf(jgf, gf)
    GR.check_gradient_valid(g, gf, torch.from_numpy(order))


def test_check_gradient_valid_catches_corruption():
    g, jg, order = _orders((5, 4, 3), seed=6)
    jgf = JGR.compute_gradient(jg, order, backend="jax")
    crit = {k: v.copy() for k, v in jgf.crit.items()}
    crit[0][np.nonzero(~crit[0])[0][0]] = True
    gf = GR.gradient_from_numpy(g, jgf.pair_up, jgf.pair_down, crit, "cpu")
    with pytest.raises(AssertionError):
        GR.check_gradient_valid(g, gf, torch.from_numpy(order))


def test_gradient_hbm_model():
    m = ops.gradient_hbm_model((256, 256, 256))
    assert m["fused"] == {"read": 4.0, "write": 153}
    assert m["prepass"]["read"] == 28 * 4.0
    assert ops.gradient_hbm_model((2048, 2048, 1024))["fused"]["read"] == 8.0
