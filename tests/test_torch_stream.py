"""PyTorch port, streaming slice: ``repro_torch.stream`` and the streamed
route of ``PersistencePipeline`` on the CPU against the JAX package.

- the halo rows (``kernels.ops.lower_star_rows_halo``, every backend on
  CPU tensors) bit-equal to ``repro.kernels.ops._halo_rows_jax`` and to
  the prepass Pallas kernel (interpret mode) on first, interior, last and
  whole-grid ext volumes, thin, 2-D and 1-D grids;
- ``plan_chunks`` / ``plan_shards``, the (value, vid) keys (numpy and
  torch twins), ``ranks_for_vids`` and ``SparseOrder`` equal to the
  reference's;
- ``stream_front`` and ``sharded_stream_front``: the same gradient
  arrays, keys and byte / count accounting as the reference's;
- diagram parity: ``diagram_stream`` (one shard, 2 and 4 shards) gives
  wire payloads byte-identical to the reference's streamed payload and
  to the port's in-memory payload, over fields, grids and sources.

Integer results are compared with tolerance 0; timings are not compared.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import grid as JG
from repro.fields.generators import make_field as j_make_field
from repro.kernels import ops as JOPS
from repro.pipeline import PersistencePipeline as JPipeline
from repro.pipeline import TopoRequest as JRequest
from repro.stream import ArraySource as JArraySource
from repro.stream import SparseOrder as JSparseOrder
from repro.stream import chunks as JCH
from repro.stream import ranks_for_vids as j_ranks_for_vids
from repro.stream import sharded_stream_front as j_sharded_stream_front
from repro.stream import stream_front as j_stream_front
from repro.stream.scheduler import _ext_volume as j_ext_volume

from repro_torch.core.grid import Grid, vertex_order
from repro_torch.fields.generators import make_field
from repro_torch.kernels import ops
from repro_torch.pipeline import (Backend, PersistencePipeline, TopoRequest,
                                  get_backend)
from repro_torch.stream import (ArraySource, FunctionSource, HaloExchange,
                                HaloExchangeTimeout, MemmapSource,
                                SparseOrder, diagram_vertices,
                                pack_value_keys, pack_value_keys_torch,
                                plan_chunks, plan_shards, ranks_for_vids,
                                sharded_stream_front, sortable32,
                                stream_front, unpack_value_keys,
                                unpack_value_keys_torch)
from repro_torch.stream.scheduler import _ext_volume


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shard engines run torch ops from several host threads at once;
    one intra-op thread each keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vol(f, dims):
    nx, ny, nz = Grid.of(*dims).dims
    return np.asarray(f, np.float32).reshape(nz, ny, nx)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------
# the halo rows
# --------------------------------------------------------------------------

def _chunk_exts(dims, chunk_z, seed=5):
    """(name, ext volume) of every chunk of a tied float32 field."""
    g = Grid.of(*dims)
    nx, ny, _ = g.dims
    f = np.random.default_rng(seed).integers(0, 5, g.nv).astype(np.float32)
    keys = pack_value_keys(f, np.arange(g.nv, dtype=np.int64))
    for c in plan_chunks(g.dims, chunk_z=chunk_z):
        yield c, j_ext_volume(keys[c.glo * nx * ny: c.ghi * nx * ny],
                              c, g.dims)


# (dims, chunk_z): first / interior / last chunks, a whole-grid chunk
# (two -1 ghosts), one-plane chunks, thin, 2-D and 1-D grids
HALO_CASES = [((5, 4, 7), 2), ((6, 5, 4), 4), ((1, 5, 6), 1),
              ((7, 1, 5), 3), ((9, 4, 1), 1), ((16, 1, 1), 1)]


@pytest.mark.parametrize("dims,chunk_z", HALO_CASES)
def test_halo_rows_match_reference(dims, chunk_z):
    """Every backend's halo rows equal ``_halo_rows_jax`` (tolerance 0),
    and on the 3-D cases the prepass Pallas kernel agrees with both."""
    for c, ext in _chunk_exts(dims, chunk_z):
        want = [np.asarray(a) for a in JOPS._halo_rows_jax(jnp.asarray(ext))]
        for backend in ("torch", "fused", "prepass"):
            got = ops.lower_star_rows_halo(torch.from_numpy(ext), backend)
            for a, b, name in zip(want, got, ("st", "pt", "vs", "vp")):
                np.testing.assert_array_equal(
                    b.numpy(), a, err_msg=f"{dims} {c} {backend} {name}")
    if len(dims) == 3 and min(dims) > 1:     # interpret mode is slow
        pallas = JOPS.lower_star_rows_halo(ext, backend="pallas_prepass")
        for a, b in zip(pallas, want):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_ext_volume_matches_reference():
    dims = (5, 4, 9)
    g = Grid.of(*dims)
    f = make_field("isabel", dims, seed=0)
    keys = pack_value_keys(f, np.arange(g.nv, dtype=np.int64))
    plane = 20
    lo, hi = np.arange(plane) + 7, np.arange(plane) + 99
    for c in plan_chunks(dims, chunk_z=2, window=(2, 7), halo_below=True,
                         halo_above=True):
        ks = keys[c.glo * plane: c.ghi * plane]
        want = j_ext_volume(ks, c, dims, halo_lo=lo, halo_hi=hi)
        got = _ext_volume(torch.from_numpy(ks), c, dims,
                          halo_lo=torch.from_numpy(lo),
                          halo_hi=torch.from_numpy(hi))
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# decomposition, keys, rank recovery
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims,kw", [
    ((4, 4, 32), dict(chunk_z=5)), ((3, 3, 7), dict(chunk_z=3)),
    ((5, 5, 4), dict(chunk_z=9)), ((8, 8, 32), dict(chunk_budget=6 * 256)),
    ((8, 8, 32), dict(chunk_budget=1)),
    ((4, 4, 32), dict(chunk_z=3, window=(8, 16), halo_below=True,
                      halo_above=True)),
    ((4, 4, 32), dict(chunk_z=3, window=(24, 32), halo_below=True))])
def test_plan_chunks_matches_reference(dims, kw):
    assert plan_chunks(dims, **kw) == [
        type(plan_chunks(dims, **kw)[0])(**c.__dict__)
        for c in JCH.plan_chunks(dims, **kw)]


def test_plan_shards_matches_reference():
    for nz, ns in ((32, 4), (17, 4), (9, 2), (7, 7), (100, 8), (3, 8)):
        assert plan_shards(nz, ns) == JCH.plan_shards(nz, ns)
    with pytest.raises(ValueError, match="n_shards"):
        plan_shards(16, 0)


def _tied_values(n=4000):
    rng = np.random.default_rng(0)
    f = rng.standard_normal(n).astype(np.float32)
    f[100:120] = 1.5          # exact ties -> vid tie-break
    f[7], f[9] = -0.0, 0.0    # signed-zero tie
    f[11], f[12] = np.float32(3e38), np.float32(-3e38)
    return f


def test_packed_keys_match_reference_numpy_and_torch():
    f = _tied_values()
    vids = np.arange(len(f), dtype=np.int64)
    want = JCH.pack_value_keys(f, vids)
    np.testing.assert_array_equal(pack_value_keys(f, vids), want)
    np.testing.assert_array_equal(
        pack_value_keys_torch(torch.from_numpy(f), 0).numpy(), want)
    # a slab at an offset packs its global vids
    np.testing.assert_array_equal(
        pack_value_keys_torch(torch.from_numpy(f[1000:2000]), 1000).numpy(),
        want[1000:2000])
    np.testing.assert_array_equal(sortable32(f), JCH.sortable32(f))
    back = JCH.unpack_value_keys(want)
    np.testing.assert_array_equal(unpack_value_keys(want), back)
    np.testing.assert_array_equal(
        unpack_value_keys_torch(torch.from_numpy(want)).numpy(), back)
    # order-isomorphic to the port's vertex order
    order = np.empty(len(f), np.int64)
    order[np.argsort(want)] = np.arange(len(f))
    np.testing.assert_array_equal(
        order, vertex_order(torch.from_numpy(f)).numpy())


def test_ranks_for_vids_and_sparse_order_match_reference():
    f = _tied_values(3000)
    keys = JCH.pack_value_keys(f, np.arange(len(f), dtype=np.int64))
    q = np.random.default_rng(1).integers(0, len(f), size=64)
    want = j_ranks_for_vids(keys, q, slab=257)
    tk = torch.from_numpy(keys)
    np.testing.assert_array_equal(ranks_for_vids(tk, q, slab=257).numpy(),
                                  want)
    so, jso = SparseOrder.from_keys(tk, q), JSparseOrder.from_keys(keys, q)
    assert len(so) == len(jso) == len(f)
    idx = q[::-1].copy().reshape(8, 8)
    np.testing.assert_array_equal(so[torch.from_numpy(idx)].numpy(),
                                  jso[idx])
    missing = np.setdiff1d(np.arange(len(f)), q)[:1]
    with pytest.raises(KeyError, match="not registered"):
        so[torch.from_numpy(missing)]
    with pytest.raises(KeyError, match="not registered"):
        SparseOrder(10, torch.zeros(0, dtype=torch.int64),
                    torch.zeros(0, dtype=torch.int64))[torch.tensor([3])]


def test_sources_serve_the_reference_slabs(tmp_path):
    dims = (5, 4, 9)
    f = vol(make_field("random", dims, seed=3), dims)
    src = MemmapSource.write(os.path.join(tmp_path, "f.raw"), f)
    np.testing.assert_array_equal(src.read_slab(3, 6), f[3:6])
    fs = FunctionSource.synthetic("truss", dims, seed=2)
    np.testing.assert_array_equal(
        fs.read_slab(2, 7),
        vol(j_make_field("truss", dims, seed=2), dims)[2:7])
    with pytest.raises(TypeError, match="float32"):
        ArraySource(np.zeros((4, 4, 4)))


# --------------------------------------------------------------------------
# front-ends against the reference's
# --------------------------------------------------------------------------

_REPORT_FIELDS = ("dims", "backend", "n_chunks", "chunk_z",
                  "max_chunk_bytes", "peak_resident_field_bytes",
                  "total_loaded_bytes", "key_bytes", "n_shards")


def _assert_same_front(got, want, kernel, sharded=False):
    for k in want.gf.crit:
        np.testing.assert_array_equal(_np(got.gf.crit[k]), want.gf.crit[k])
    for name in ("pair_up", "pair_down"):
        a, b = getattr(got.gf, name), getattr(want.gf, name)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(_np(a[k]), b[k], err_msg=name)
    np.testing.assert_array_equal(_np(got.keys), want.keys)
    # a sharded run's peak over all shards depends on how their threads
    # interleave; the per-shard peaks are compared instead
    for f in _REPORT_FIELDS[:5] + _REPORT_FIELDS[6 if sharded else 5:]:
        g, w = getattr(got.report, f), getattr(want.report, f)
        assert g == (kernel if f == "backend" else w), f
    assert got.chunks == [type(got.chunks[0])(**c.__dict__)
                          for c in want.chunks]


@pytest.mark.parametrize("kernel", ["fused", "prepass", "torch"])
def test_stream_front_matches_reference(kernel):
    dims = (6, 7, 10)
    f = vol(make_field("backpack", dims, seed=1), dims)
    want = j_stream_front(JArraySource(f), kernel="jax", chunk_z=3)
    got = stream_front(ArraySource(f), kernel=kernel, chunk_z=3,
                       device="cpu")
    _assert_same_front(got, want, kernel)
    assert got.report.peak_resident_field_bytes \
        <= 2 * got.report.max_chunk_bytes


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_stream_front_matches_reference(n_shards):
    dims = (6, 7, 20)
    f = vol(make_field("backpack", dims, seed=1), dims)
    want = j_sharded_stream_front(JArraySource(f), n_shards, kernel="jax",
                                  chunk_z=3)
    got = sharded_stream_front(ArraySource(f), n_shards, chunk_z=3,
                               device="cpu")
    _assert_same_front(got, want, "fused", sharded=True)
    for a, b in zip(got.report.per_shard, want.report.per_shard):
        for k in ("shard", "z0", "z1", "n_chunks", "loaded_bytes",
                  "halo_planes", "peak_resident_field_bytes",
                  "max_chunk_bytes"):
            assert a[k] == b[k], k
    assert got.report.overlap_fraction is not None
    one = stream_front(ArraySource(f), chunk_z=3, device="cpu")
    for k in one.gf.crit:
        assert torch.equal(one.gf.crit[k], got.gf.crit[k])
    assert torch.equal(one.keys, got.keys)


def test_sharded_front_under_thread_contention():
    """More shards than cores, with a short switch interval: the shards'
    concurrent scatters (disjoint sids) still give the single-shard
    result."""
    import sys
    from repro_torch.kernels import lower_star as LS
    dims = (5, 4, 16)
    f = vol(make_field("random", dims, seed=6), dims)
    want = stream_front(ArraySource(f), chunk_z=1, device="cpu")
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n0 = LS.LAUNCHES["fused_halo"]
        got = sharded_stream_front(ArraySource(f), 12, chunk_z=1,
                                   device="cpu")
        assert LS.LAUNCHES["fused_halo"] == n0   # CPU tensors: no launch
    finally:
        sys.setswitchinterval(before)
    assert got.report.n_shards == 12
    for k in want.gf.crit:
        assert torch.equal(got.gf.crit[k], want.gf.crit[k])
    for k in want.gf.pair_up:
        assert torch.equal(got.gf.pair_up[k], want.gf.pair_up[k])
    for k in want.gf.pair_down:
        assert torch.equal(got.gf.pair_down[k], want.gf.pair_down[k])
    assert torch.equal(got.keys, want.keys)


def _cpu_cards(n):
    """``n`` distinct CPU devices standing in for cards: a tensor moved to
    any of them stays on the CPU, so every cross-card step of the sharded
    engine runs here."""
    return [torch.device("cpu", i) for i in range(n)]


@pytest.mark.parametrize("n_cards", [1, 2, 3, 4])
def test_shard_devices_map_shard_s_to_card_s_mod_n(n_cards, monkeypatch):
    """Every visible card in index order for a CUDA home, ``[home]`` for
    a CPU one; shard ``s`` runs on ``devices[s % N]`` for 2, 4 and 5
    shards (its ``per_shard`` entry names it)."""
    from repro_torch.stream import sharded as SS
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    assert SS._shard_devices(torch.device("cuda", 0)) == [
        torch.device("cuda", i) for i in range(n_cards)]
    assert SS._shard_devices(torch.device("cpu")) == [torch.device("cpu")]
    cards = _cpu_cards(n_cards)
    monkeypatch.setattr(SS, "_shard_devices", lambda home: cards)
    dims = (4, 3, 10)
    f = vol(make_field("random", dims, seed=2), dims)
    for n_shards in (2, 4, 5):
        got = sharded_stream_front(ArraySource(f), n_shards, chunk_z=1,
                                   device="cpu")
        assert [st["device"] for st in got.report.per_shard] == [
            str(cards[s % n_cards]) for s in range(n_shards)]


def test_sharded_front_across_two_devices(monkeypatch):
    """4 shards over two distinct devices (``cpu`` home, ``cpu:1``):
    gradient, keys and ``per_shard`` equal to the reference's
    ``sharded_stream_front`` and to one shard's run; the shards off home
    account their rows, keys and halo planes as link bytes; the plan
    names both devices."""
    from repro_torch.stream import sharded as SS
    cards = [torch.device("cpu"), torch.device("cpu", 1)]
    monkeypatch.setattr(SS, "_shard_devices", lambda home: cards)
    dims = (6, 7, 20)
    f = vol(make_field("backpack", dims, seed=1), dims)
    want = j_sharded_stream_front(JArraySource(f), 4, kernel="jax",
                                  chunk_z=3)
    got = sharded_stream_front(ArraySource(f), 4, chunk_z=3, device="cpu")
    _assert_same_front(got, want, "fused", sharded=True)
    plane = 6 * 7
    for a, b in zip(got.report.per_shard, want.report.per_shard):
        for k in b:
            if not k.endswith("_s"):
                assert a[k] == b[k], k
        assert a["device"] == str(cards[a["shard"] % 2])
        assert a["peak_device_bytes"] is None
        owned = (a["z1"] - a["z0"]) * plane
        # every neighbour plane comes from the other device; on cpu:1 every
        # owned vertex's key and rows (8 + 153 B) also go home
        assert a["link_bytes"] == a["halo_planes"] * plane * 8 \
            + (owned * 161 if a["shard"] % 2 else 0)
    one = stream_front(ArraySource(f), chunk_z=3, device="cpu")
    for name in ("crit", "pair_up", "pair_down"):
        for k, v in getattr(one.gf, name).items():
            assert torch.equal(v, getattr(got.gf, name)[k]), name
    assert torch.equal(one.keys, got.keys)
    plan = PersistencePipeline(device="cpu").lower(TopoRequest(
        field=ArraySource(f), stream=True, chunk_z=3, n_blocks=4,
        distributed=False))
    assert "sharded-streamed x4 over cpu, cpu:1" in plan.describe()


def test_halo_exchange_round_trip_and_timeout():
    ex = HaloExchange(3)
    plane = torch.arange(12, dtype=torch.int64)
    ex.publish(1, "last", plane)
    assert torch.equal(ex.recv(1, "last", timeout=1.0), plane)
    assert torch.equal(ex.recv(1, "last", device=torch.device("cpu", 1)),
                       plane)
    with pytest.raises(HaloExchangeTimeout, match="shard 1"):
        ex.recv(1, "first", timeout=0.05, waiter=2, plane_z=4)


def test_diagram_vertices_cover_the_diagram():
    dims = (6, 5, 7)
    f = make_field("random", dims, seed=2)
    res = PersistencePipeline(device="cpu").run(
        TopoRequest(field=ArraySource(vol(f, dims)), chunk_z=3))
    dg = res.diagram
    vs = diagram_vertices(dg.grid, dg.pairs, dg.essential)
    assert torch.equal(vs, torch.unique(vs))
    order = vertex_order(torch.from_numpy(f))
    assert torch.equal(dg.order[vs], order[vs])


# --------------------------------------------------------------------------
# diagram parity: port streamed == reference streamed == port in-memory
# --------------------------------------------------------------------------

def _ref_stream(src, **kw):
    return JPipeline(backend="jax", sandwich_backend="jax").run(
        JRequest(field=src, stream=True, **kw))


def _port_memory(f, dims):
    return PersistencePipeline(device="cpu").run(
        TopoRequest(field=f, grid=Grid.of(*dims)))


@pytest.mark.parametrize("name", ["wavelet", "random", "isabel"])
@pytest.mark.parametrize("dims,chunk_z", [((10, 6, 13), 4),   # asymmetric
                                          ((4, 3, 11), 3),    # thin
                                          ((12, 9, 1), 1)])   # 2-D
def test_stream_payload_parity(name, dims, chunk_z):
    f = make_field(name, dims, seed=0)
    want = _ref_stream(JArraySource(vol(f, dims)), chunk_z=chunk_z)
    got = PersistencePipeline(device="cpu").diagram_stream(
        ArraySource(vol(f, dims)), chunk_z=chunk_z)
    assert got.stream.n_chunks == want.stream.n_chunks >= 1
    assert got.to_bytes() == want.to_bytes()
    assert got.to_bytes() == _port_memory(f, dims).to_bytes()


@pytest.mark.parametrize("name", ["wavelet", "random", "isabel"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_payload_parity(name, n_shards):
    dims = (8, 5, 16)
    f = make_field(name, dims, seed=0)
    kw = dict(chunk_z=3, n_blocks=n_shards, distributed=False)
    want = _ref_stream(JArraySource(vol(f, dims)), **kw)
    got = PersistencePipeline(device="cpu").run(
        TopoRequest(field=ArraySource(vol(f, dims)), stream=True, **kw))
    assert got.stream.n_shards == want.stream.n_shards == n_shards
    for st in got.stream.per_shard:
        assert st["peak_resident_field_bytes"] <= 2 * st["max_chunk_bytes"]
    assert "sharded-streamed x" in got.plan.describe()
    assert got.to_bytes() == want.to_bytes()
    assert got.to_bytes() == _port_memory(f, dims).to_bytes()


@pytest.mark.parametrize("kind", ["uneven_slabs", "memmap", "function",
                                  "memmap_4_shards", "tensor_field"])
def test_payload_parity_sources(kind, tmp_path):
    dims = (10, 6, 17) if kind == "uneven_slabs" else (7, 6, 12)
    name = "isabel"
    f = make_field(name, dims, seed=0)
    kw = dict(chunk_z=5)
    if kind == "uneven_slabs":       # nz = 17 over 4 shards: 5, 4, 4, 4
        src = ArraySource(vol(f, dims))
        kw = dict(chunk_z=2, n_blocks=4, distributed=False)
    elif kind.startswith("memmap"):
        src = MemmapSource.write(os.path.join(tmp_path, "f.raw"),
                                 vol(f, dims))
        if kind == "memmap_4_shards":
            kw = dict(chunk_z=3, n_blocks=4, distributed=False)
    elif kind == "function":
        src = FunctionSource.synthetic(name, dims, seed=0)
    else:                            # an in-memory tensor, stream=True
        src = torch.from_numpy(vol(f, dims))
    got = PersistencePipeline(device="cpu").run(
        TopoRequest(field=src, stream=True, **kw))
    want = _port_memory(f, dims)
    assert got.to_bytes() == want.to_bytes()
    assert want.to_bytes() == JPipeline(backend="jax").run(
        JRequest(field=f, grid=JG.Grid.of(*dims))).to_bytes()


@pytest.mark.parametrize("backend", ["prepass", "torch"])
def test_stream_other_backends(backend):
    dims = (6, 5, 9)
    f = make_field("random", dims, seed=4)
    got = PersistencePipeline(backend, device="cpu").diagram_stream(
        ArraySource(vol(f, dims)), chunk_budget=3 * 30 * 4)
    assert got.stream.backend == backend and got.stream.n_chunks == 9
    assert got.to_bytes() == _port_memory(f, dims).to_bytes()


def test_streamed_request_surface():
    f = vol(make_field("wavelet", (5, 4, 6), seed=0), (5, 4, 6))
    pipe = PersistencePipeline(device="cpu")
    plan = pipe.lower(TopoRequest(field=ArraySource(f), chunk_z=2))
    assert plan.streamed and plan.stage_names[:2] == ("gradient",
                                                      "extract_sort")
    assert "streamed on cpu" in plan.describe()
    assert plan.key != pipe.lower(f).key
    with pytest.raises(ValueError, match="stream=False"):
        pipe.run(TopoRequest(field=ArraySource(f), stream=False))
    with pytest.raises(ValueError, match="only apply to streamed"):
        pipe.run(TopoRequest(field=f, chunk_z=2, stream=False))
    with pytest.raises(ValueError, match="at most one"):
        TopoRequest(field=f, chunk_z=2, chunk_budget=10)
    with pytest.raises(ValueError, match="conflict"):
        pipe.run(TopoRequest(field=ArraySource(f), grid=Grid.of(5, 4, 7)))
    # the distributed engines: streamed (sharded front-end + distributed
    # back-end) and in memory, each equal to the reference's payload
    ref = JPipeline(backend="jax")
    for kw in (dict(n_blocks=2), dict(n_blocks=2, distributed=True),
               dict(distributed=True)):
        got = pipe.run(TopoRequest(field=ArraySource(f), **kw))
        want = ref.run(JRequest(field=JArraySource(f), **kw))
        assert got.plan.distributed and want.plan.distributed
        assert got.to_bytes() == want.to_bytes()
        assert got.stats["d0_rounds"] == want.stats["d0_rounds"]
    got = pipe.run(TopoRequest(field=f, n_blocks=2, distributed=False))
    want = ref.run(JRequest(field=f, n_blocks=2, distributed=False))
    assert not got.plan.distributed and got.plan.n_blocks == 2
    assert got.to_bytes() == want.to_bytes()
    plain = PersistencePipeline(Backend("plain", get_backend("torch").rows),
                                device="cpu")
    with pytest.raises(ValueError, match="no streamed kernel"):
        plain.diagram_stream(ArraySource(f), chunk_z=2)
    res = pipe.run_batch([TopoRequest(field=ArraySource(f), chunk_z=2), f])
    assert res[0].stream is not None and res[1].stream is None
    assert res[0].to_bytes() == res[1].to_bytes()
