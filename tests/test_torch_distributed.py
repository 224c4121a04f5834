"""PyTorch port, the distributed engines on the CPU
(``repro_torch.distributed``, ``core.ddms``, ``distributed=True`` /
``n_blocks`` requests and the ``shardmap`` backend), held bit-exact
against the JAX package:

- the front-end (sample sort, halo gradient, ring resolution, triplet
  emission) over a ``LocalRing``: every check of ``tests/shardmap_check.py``
  against the same single-device oracles, the 16-block ring regression and
  the ``crit_cap`` raise; every output array equal to the reference's
  ``run_front`` on 4 forced host devices (``torch_distributed_ref.py``);
  ``overlap_comm`` on and off equal; a gloo ``GroupRing`` of 2 processes
  equal to the ``LocalRing`` (``torch_distributed_group.py``);
- the ring across ranks (gloo, ``torch_distributed_group.py``): every
  ``GroupRing`` collective equal to ``LocalRing``'s at (world, blocks
  per rank) (2, 1), (2, 2) and (4, 1); every ``torch_distributed_ref.py``
  case over 2 ranks x 2 blocks equal to the reference's 4 devices, on
  every rank; the ``shardmap`` pipeline over 2 x 2 byte-equal to the JAX
  package on every rank; ``block_ring``'s choice and its errors;
  ``examples/distributed_pd_torch.py`` under ``torchrun`` with 2 ranks;
- ``pairing_fixpoint`` and ``d1_distributed``: pairs and every statistic
  equal to the reference's on ``tests/test_ddms.py``'s matrix;
- the pipeline: payloads byte-equal to the reference's
  ``PersistencePipeline(backend="jax", n_blocks=n, distributed=True)``,
  with equal distributed counters, streamed requests included.

The reference names its gradient backends ``jax`` and ``pallas``; the
port's are ``torch`` (the plain version) and ``prepass``.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import grid as JG
from repro.core.critical import extract_critical
from repro.core.ddms import compute_ddms_sim as j_compute_ddms_sim
from repro.core.extremum_graph import build_d0_graph, build_dual_graph
from repro.core.gradient import compute_gradient_np
from repro.core.grid import vertex_order as j_vertex_order
from repro.core.pairing import pair_extrema_saddles
from repro.distributed.d1_rounds import d1_distributed as j_d1_distributed
from repro.distributed.pairing_rounds import \
    pairing_fixpoint as j_pairing_fixpoint
from repro.pipeline import PersistencePipeline as JPipeline
from repro.pipeline import TopoRequest as JRequest
from repro.stream import ArraySource as JArraySource

from repro_torch.core.critical import CriticalInfo
from repro_torch.core.ddms import compute_ddms_sim
from repro_torch.core.extremum_graph import ExtremumGraph
from repro_torch.core.gradient import gradient_from_numpy
from repro_torch.core.grid import Grid
from repro_torch.distributed import (CritCapacityError, FrontConfig,
                                     LocalRing, block_ring, front_triplets,
                                     run_front)
from repro_torch.distributed.d1_rounds import d1_distributed
from repro_torch.distributed.pairing_rounds import pairing_fixpoint
from repro_torch.kernels.sandwich import pair_extrema_saddles_kernel
from repro_torch.pipeline import PersistencePipeline, TopoRequest
from repro_torch.stream import ArraySource

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_distributed_group as GROUP  # noqa: E402
import torch_distributed_ref as REF  # noqa: E402

BACKEND = GROUP.BACKEND
COUNTERS = ("d0_rounds", "d0_corrections", "d_top_rounds", "d1_rounds",
            "d1_token_hops", "d1_expansions", "d1_merges", "d1_steals",
            "n_blocks")


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    return env


def _field(dims, seed):
    n = int(np.prod(dims))
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# --------------------------------------------------------------------------
# front-end
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _oracle(dims, f_bytes):
    """The single-device reference front-end (as ``shardmap_check``):
    vertex order, critical counts, D0 and dual triplet sets."""
    g = JG.Grid.of(*dims)
    f = np.frombuffer(f_bytes, np.float32)
    order = np.asarray(j_vertex_order(f.astype(np.float64)))
    gf = compute_gradient_np(g, order)
    ci = extract_critical(g, gf, order)
    g0 = build_d0_graph(g, gf, ci)
    gD = build_dual_graph(g, gf, ci, ci.crit_sids[2])

    def triplets(gr):
        return {(int(s), frozenset((int(a), int(b))))
                for s, a, b in zip(gr.saddles, gr.t0, gr.t1)}
    return order, [len(ci.crit_sids[k]) for k in range(4)], \
        triplets(g0), triplets(gD)


def _got_triplets(sid, t0, t1):
    return {(int(s), frozenset((int(a), int(b))))
            for s, a, b in zip(sid.tolist(), t0.tolist(), t1.tolist())
            if a != b}


@pytest.mark.parametrize("dims,seed,n_blocks,sort,backend", [
    ((6, 5, 16), 0, 8, True, "jax"), ((6, 5, 16), 1, 8, True, "jax"),
    ((5, 4, 24), 2, 8, True, "jax"), ((6, 5, 16), 3, 8, False, "jax"),
    ((6, 5, 16), 3, 8, True, "pallas"), ((5, 4, 16), 5, 8, True, "fused"),
    ((4, 4, 8), 4, 4, True, "jax")])
def test_front_matches_single_device_oracles(dims, seed, n_blocks, sort,
                                             backend):
    """``shardmap_check.check`` through a LocalRing."""
    f = _field(dims, seed)
    order, ncrit, ref0, refd = _oracle(dims, f.tobytes())
    cfg, out = run_front(dims, f, n_blocks, device="cpu",
                         use_sample_sort=sort,
                         gradient_backend=BACKEND[backend], sort_slack=4.0)
    assert not bool(out["overflow"]) and int(out["unresolved"]) == 0
    ranks = out["ranks"].numpy()
    if sort:
        assert np.array_equal(ranks, order)
    else:
        assert np.array_equal(np.argsort(np.argsort(ranks)), order)
        assert (ranks >= 0).all()
    assert out["ncrit"].tolist() == ncrit
    (sid0, _, t0, t1), (sidd, _, s0, s1) = front_triplets(dims, out)
    assert _got_triplets(sid0, t0, t1) == ref0
    assert _got_triplets(sidd, s0, s1) == refd


def test_ring_rotation_regression_16_blocks():
    """Chains crossing 15 slab boundaries: the derived rotation count
    resolves both orientations exactly; the old constant 3 reports its
    failure through ``unresolved`` on at least one."""
    n_blocks = 16
    dims = (3, 2, 4 * n_blocks)
    failed_with_3 = 0
    for min_at_top in (True, False):
        f = REF.ridge_field(dims, min_at_top)
        _, _, ref0, _ = _oracle(dims, f.tobytes())
        _, out = run_front(dims, f, n_blocks, device="cpu",
                           use_sample_sort=False)
        assert int(out["unresolved"]) == 0
        (sid0, _, t0, t1), _ = front_triplets(dims, out)
        assert _got_triplets(sid0, t0, t1) == ref0
        _, out3 = run_front(dims, f, n_blocks, device="cpu",
                            use_sample_sort=False, ring_rotations=3)
        failed_with_3 += int(int(out3["unresolved"]) > 0)
    assert failed_with_3 > 0


def test_crit_capacity_raises():
    dims = (6, 5, 16)
    with pytest.raises(CritCapacityError) as e:
        run_front(dims, _field(dims, 7), 8, device="cpu", sort_slack=4.0,
                  crit_cap=2)
    assert e.value.observed > e.value.cap == 2


@pytest.fixture(scope="module")
def reference_front(tmp_path_factory):
    """The reference's run_front outputs on 4 forced host devices."""
    out = str(tmp_path_factory.mktemp("ref") / "front.npz")
    script = os.path.join(HERE, "torch_distributed_ref.py")
    r = subprocess.run([sys.executable, script, out], capture_output=True,
                       text=True, timeout=600, env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    return np.load(out)


@pytest.mark.parametrize("name", sorted(REF.CASES))
def test_front_equals_reference_arrays(reference_front, name):
    dims, seed, kw = REF.CASES[name]
    kw = dict(kw, gradient_backend=BACKEND[kw["gradient_backend"]])
    _, out = run_front(dims, REF.case_field(dims, seed), REF.N_DEV,
                       device="cpu", **kw)
    keys = {k.split("/", 1)[1] for k in reference_front.files
            if k.startswith(name + "/")}
    assert keys == set(out)
    for k, v in out.items():
        want = reference_front[f"{name}/{k}"]
        got = v.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("backend", ["torch", "prepass"])
def test_overlap_comm_gives_identical_outputs(backend):
    dims = (5, 4, 24)
    f = _field(dims, 6)
    stats = {}
    _, a = run_front(dims, f, 4, device="cpu", gradient_backend=backend,
                     overlap_comm=True, stats=stats)
    _, b = run_front(dims, f, 4, device="cpu", gradient_backend=backend,
                     overlap_comm=False)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a LocalRing has no collectives to time: no comm step
    assert set(stats["steps"]) == {"order", "halo", "gradient", "successors",
                                   "emission", "resolution", "gather"}
    assert stats["ring_rotations"]["v"] >= 1
    assert stats["sort_bucket_peak"] <= stats["sort_percap"]


# (world, blocks per rank) -> the jobs of torch_distributed_group.py
GROUP_RUNS = {(2, 1): ("front", "ring", "stats"),
              (2, 2): ("ring", "ref", "pipeline"),
              (4, 1): ("ring",)}


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """Every rank's results of one gloo run per (world, blocks per rank),
    made once per module."""
    done = {}

    def get(world, blocks):
        if (world, blocks) not in done:
            out = str(tmp_path_factory.mktemp("group") / "out.pt")
            r = subprocess.run(
                [sys.executable, os.path.join(HERE,
                                              "torch_distributed_group.py"),
                 out, "--world", str(world), "--blocks", str(blocks),
                 "--jobs", *GROUP_RUNS[world, blocks]],
                capture_output=True, text=True, timeout=300, env=_env())
            assert r.returncode == 0, r.stderr[-4000:]
            done[world, blocks] = torch.load(out)["ranks"]
        return done[world, blocks]
    return get


def test_group_ring_equals_local_ring(group_run):
    ranks = group_run(GROUP.WORLD, 1)
    for name, (dims, seed, kw) in GROUP.CASES.items():
        _, want = run_front(dims, GROUP.case_field(dims, seed), GROUP.WORLD,
                            device="cpu", **kw)
        for got in ranks:
            for k, v in want.items():
                assert v.dtype == got[name][k].dtype, (name, k)
                assert torch.equal(v, got[name][k]), (name, k)


def test_group_front_stats_add_gather_and_comm(group_run):
    """Over 2 gloo ranks, ``stats`` gets the six steps, ``gather`` and
    ``comm`` (the ring's collectives, > 0), within their sum; without
    ``stats`` the outputs are the same and nothing is recorded."""
    six = {"order", "halo", "gradient", "successors", "emission",
           "resolution"}
    for got in group_run(2, 1):
        steps = got["stats_steps"]
        assert set(steps) == six | {"gather", "comm"}
        assert 0 < steps["comm"] <= sum(steps[k] for k in six | {"gather"})
        assert steps["gather"] > 0
        assert got["stats_same"] is True


@pytest.mark.parametrize("world,blocks", sorted(GROUP_RUNS))
def test_group_ring_collectives_equal_local_ring(group_run, world, blocks):
    """Shifts up and down with and without wrap (and started async),
    all_gather, all_to_all, psum, pmax, gather_blocks and blocks of a
    GroupRing with ``blocks`` blocks per rank: each rank's share of the
    LocalRing's results over all ``world * blocks`` blocks."""
    nb = world * blocks
    want = GROUP.ring_ops(LocalRing(nb, device="cpu"), GROUP.ring_inputs(nb))
    ranks = group_run(world, blocks)
    assert len(ranks) == world
    for r, got in enumerate(ranks):
        assert got["ring_type"] == "GroupRing"
        assert set(got["ring"]) == set(want)
        for k, w in want.items():
            if k != "gather_blocks_x":
                w = w[r * blocks:(r + 1) * blocks]
            g = got["ring"][k]
            assert g.dtype == w.dtype and torch.equal(g, w), (r, k)


@pytest.mark.parametrize("name", sorted(REF.CASES))
def test_group_front_equals_reference_arrays(reference_front, group_run,
                                             name):
    """run_front over 2 gloo ranks x 2 blocks (the default ring of a
    process group) equals the reference's 4 devices on every rank."""
    ranks = group_run(2, 2)
    keys = {k.split("/", 1)[1] for k in reference_front.files
            if k.startswith(name + "/")}
    for got in ranks:
        out = got["ref_" + name]
        assert keys == set(out)
        for k, v in out.items():
            want = reference_front[f"{name}/{k}"]
            assert v.numpy().dtype == want.dtype, k
            assert v.shape == want.shape and np.array_equal(v.numpy(),
                                                            want), k


@pytest.mark.parametrize("distributed", [False, True])
def test_group_shardmap_pipeline_equals_reference(group_run, distributed):
    """The shardmap pipeline over 2 gloo ranks x 2 blocks: every rank's
    payload byte-equal to the JAX package's (and its counters)."""
    dims = GROUP.PIPELINE_DIMS
    kw = dict(n_blocks=4, distributed=True) if distributed else {}
    want = JPipeline(backend="jax", **kw).run(
        JRequest(field=GROUP.pipeline_field(), grid=JG.Grid.of(*dims)))
    for got in group_run(2, 2):
        assert got[f"payload_{distributed}"] == want.to_bytes()
        if distributed:
            assert {k: got["stats_True"].get(k) for k in COUNTERS} == \
                _counters(want)


def test_group_block_count_and_device_errors(group_run):
    """Over 2 ranks, 3 blocks raise ValueError naming both numbers (from
    block_ring and from run_front), and a device that is not the
    group's raises (from block_ring, from a shardmap pipeline's run, and
    from run_front given no device= and a field off the host), with no
    copy to or from it."""
    for got in group_run(2, 2):
        for key in ("indivisible", "indivisible_front"):
            assert got[key] is not None and "n_blocks=3" in got[key] \
                and "2 ranks" in got[key], got[key]
        for key in ("wrong_device", "wrong_device_pipeline",
                    "field_off_host"):
            assert got[key] is not None and "not on meta" in got[key]


def test_block_ring_without_a_real_group():
    """No group: a LocalRing, on the card unless asked (raising where
    there is no card); the dry-run's fake group does not count as
    one."""
    from repro_torch.launch.dryrun import _fake_world
    ring = block_ring(4, "cpu")
    assert isinstance(ring, LocalRing) and ring.device.type == "cpu"
    if torch.cuda.is_available():
        for ring in (block_ring(4), LocalRing(4)):
            assert isinstance(ring, LocalRing)
            assert ring.device == torch.device(
                "cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            block_ring(4)
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalRing(4)
    with _fake_world(4):
        assert torch.distributed.get_backend() == "fake"
        assert isinstance(block_ring(4, "cpu"), LocalRing)


@pytest.mark.parametrize("backend", ["gloo", "cpu:gloo",
                                     "cpu:gloo,cuda:gloo"])
def test_block_ring_takes_any_real_group(tmp_path, backend):
    """Any initialised group, device-mapped backends too, gives a
    GroupRing (here one rank holding all 4 blocks, on the CPU: gloo's
    CUDA tensors do not count), whose collectives equal the LocalRing's;
    a device the group's ring does not run on raises, with no copy."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        ring = block_ring(4)
        assert type(ring).__name__ == "GroupRing" and ring.bl == 4
        assert ring.device == torch.device("cpu")
        inp = GROUP.ring_inputs(4)
        got = GROUP.ring_ops(ring, inp)
        want = GROUP.ring_ops(LocalRing(4, device="cpu"), inp)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        for dev in ("cuda", "meta"):
            with pytest.raises(ValueError, match=f"not on {dev}"):
                block_ring(4, dev)
    finally:
        dist.destroy_process_group()
    assert isinstance(block_ring(4, "cpu"), LocalRing)


def test_distributed_pd_example_over_torchrun(tmp_path):
    """``examples/distributed_pd_torch.py`` at the reference's default
    8 x 8 x 32 over 2 gloo ranks: DDMS == DMS and equal payloads on
    both ranks."""
    script = os.path.join(HERE, "..", "examples", "distributed_pd_torch.py")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", script, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=str(tmp_path))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    assert "DDMS == DMS: True; every rank's payload equal: True" in r.stdout


def test_local_ring_collectives():
    ring = LocalRing(3, device="cpu")
    x = torch.arange(6).reshape(3, 2)
    assert ring.shift(x, up=True).tolist() == [[0, 0], [0, 1], [2, 3]]
    assert ring.shift(x, up=False, wrap=True).tolist() == \
        [[2, 3], [4, 5], [0, 1]]
    assert ring.psum(x).tolist() == [[6, 9]] * 3
    assert ring.pmax(x).tolist() == [[4, 5]] * 3
    assert ring.all_gather(x).shape == (3, 3, 2)
    y = torch.arange(9).reshape(3, 3)          # y[src, dst]
    assert ring.all_to_all(y).tolist() == [[0, 3, 6], [1, 4, 7], [2, 5, 8]]
    with pytest.raises(ValueError, match="divide"):
        FrontConfig((4, 4, 6), 4).nz_local
    with pytest.raises(ValueError, match="gradient_backend"):
        FrontConfig((4, 4, 8), 4, gradient_backend="pallas")


# --------------------------------------------------------------------------
# pairing rounds and token D1
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sequential(dims, seed):
    """Reference gradient, critical info, graphs and D1 inputs."""
    g = JG.Grid.of(*dims)
    f = np.random.default_rng(seed).standard_normal(g.nv)
    order = np.asarray(j_vertex_order(f))
    gf = compute_gradient_np(g, order)
    ci = extract_critical(g, gf, order)
    g0 = build_d0_graph(g, gf, ci)
    d0s = {s for s, _ in pair_extrema_saddles(g0).pairs}
    # the dual diagram's saddles: (d-1)-simplices; in 2-D the edges D0
    # left unpaired
    dual = ci.crit_sids[g.dim - 1] if g.dim == 3 else np.asarray(
        [e for e in ci.crit_sids[1] if int(e) not in d0s], np.int64)
    gD = build_dual_graph(g, gf, ci, dual)
    dps = {s for s, _ in pair_extrema_saddles(gD).pairs}
    c1 = np.asarray([e for e in ci.crit_sids[1] if int(e) not in d0s],
                    np.int64)
    c2 = np.asarray([s for s in ci.crit_sids[2] if int(s) not in dps],
                    np.int64)
    return g, gf, ci, g0, gD, c1, c2


def _port_graph(gr):
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64))
    return ExtremumGraph(t(gr.saddles), t(gr.t0), t(gr.t1), t(gr.ext_key))


@pytest.mark.parametrize("dims,seed", [((5, 5, 4), s + 100) for s in range(5)]
                         + [((4, 4, 6), s) for s in range(4)]
                         + [((4, 4, 8), 11), ((4, 4, 8), 13)]
                         + [((7, 6), s) for s in range(3)])
def test_pairing_fixpoint_equals_reference(dims, seed):
    """Both graphs of ``test_pairing_fixpoint_equals_sequential`` and of
    ``test_ddms.py``'s fields (the round function has no block count)."""
    _, _, _, g0, gD, _, _ = _sequential(dims, seed)
    for graph in (g0, gD):
        want, wst = j_pairing_fixpoint(graph, collect_stats=True)
        got, gst = pairing_fixpoint(_port_graph(graph), collect_stats=True)
        assert got.pairs == want.pairs
        assert got.unpaired.tolist() == want.unpaired
        assert (gst.rounds, gst.proposals, gst.corrections) == \
            (wst.rounds, wst.proposals, wst.corrections)
        kern = pair_extrema_saddles_kernel(_port_graph(graph))
        assert kern.pairs == got.pairs


DDMS_MATRIX = ([((4, 4, 6), s, n, {}) for s in range(4) for n in (1, 2, 3, 4)]
               + [((4, 4, 8), 11, n, dict(anticipation=False))
                  for n in (2, 4)]
               + [((4, 4, 8), 13, 4, dict(budget=b)) for b in (1, 2, 16)])


@pytest.mark.parametrize("dims,seed,n_blocks,kw", DDMS_MATRIX)
def test_d1_distributed_equals_reference(dims, seed, n_blocks, kw):
    g, gf, ci, _, _, c1, c2 = _sequential(dims, seed)
    want, wst = j_d1_distributed(g, gf, ci, c1, c2, n_blocks, **kw)
    grid = Grid.of(*dims)
    pgf = gradient_from_numpy(grid, gf.pair_up, gf.pair_down, gf.crit, "cpu")
    pci = CriticalInfo.from_numpy(grid, ci.order, ci.crit_sids, ci.ranks,
                                  "cpu")
    got, gst = d1_distributed(grid, pgf, pci, torch.as_tensor(c1),
                              torch.as_tensor(c2), n_blocks, **kw)
    assert got.pairs.tolist() == [list(p) for p in want.pairs]
    assert got.unpaired_edges.tolist() == list(want.unpaired_edges)
    assert got.unpaired_triangles.tolist() == list(want.unpaired_triangles)
    assert vars(gst) == vars(wst)
    assert got.expansions == want.expansions


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

def _counters(res):
    return {k: res.stats.get(k) for k in COUNTERS}


@pytest.mark.parametrize(
    "dims,seed,n_blocks,kw",
    DDMS_MATRIX[::3] + [((7, 6), s, 2, {}) for s in range(3)])
def test_distributed_pipeline_equals_reference(dims, seed, n_blocks, kw):
    f = np.random.default_rng(seed).standard_normal(int(np.prod(dims)))
    want = JPipeline(backend="jax", n_blocks=n_blocks, distributed=True,
                     **kw).run(JRequest(field=f, grid=JG.Grid.of(*dims)))
    got = PersistencePipeline(device="cpu", n_blocks=n_blocks,
                              distributed=True, **kw).run(
        TopoRequest(field=f, grid=Grid.of(*dims)))
    assert got.to_bytes() == want.to_bytes()
    assert _counters(got) == _counters(want)
    assert got.plan.distributed and "distributed back-end" in \
        got.plan.describe()
    # request-level knobs: n_blocks alone derives distributed
    req = PersistencePipeline(device="cpu").run(
        TopoRequest(field=f, grid=Grid.of(*dims), n_blocks=n_blocks, **kw))
    assert req.to_bytes() == want.to_bytes()
    assert req.plan.distributed == (n_blocks > 1)


def test_compute_ddms_sim_equals_reference():
    dims = (4, 4, 8)
    f = np.random.default_rng(3).standard_normal(128)
    want = j_compute_ddms_sim(JG.Grid.of(*dims), f, n_blocks=4,
                              gradient_backend="jax")
    got = compute_ddms_sim(Grid.of(*dims), f, n_blocks=4, device="cpu")
    for p in range(4):
        assert np.array_equal(got.diagram.essential_max_vertices(p).numpy(),
                              want.diagram.essential_max_vertices(p))
    for p in range(3):
        for a, b in zip(got.diagram.pair_max_vertices(p),
                        want.diagram.pair_max_vertices(p)):
            assert np.array_equal(a.numpy(), b)
    assert got.stats["n_blocks"] == 4 and got.stats["d1_rounds"] == \
        want.stats["d1_rounds"]


def test_streamed_sharded_request_is_distributed():
    """A streamed request with n_blocks > 1 and distributed unset runs the
    sharded streaming engine and the distributed back-end."""
    dims = (5, 4, 8)
    v = _field(dims, 2).reshape(dims[::-1])
    want = JPipeline(backend="jax").run(
        JRequest(field=JArraySource(v), n_blocks=2, chunk_z=2))
    got = PersistencePipeline(device="cpu").run(
        TopoRequest(field=ArraySource(v), n_blocks=2, chunk_z=2))
    assert got.plan.streamed and got.plan.distributed
    assert got.stream.n_shards == 2
    assert got.to_bytes() == want.to_bytes()
    assert _counters(got) == _counters(want)


def test_shardmap_backend():
    """The shardmap backend's rows equal the fused kernel's (and the
    payload the reference's); a streamed request remaps it onto the
    sharded streaming engine through the fused kernel's halo entry."""
    dims = (6, 5, 8)
    f = _field(dims, 4)
    want = JPipeline(backend="jax").run(JRequest(field=f,
                                                 grid=JG.Grid.of(*dims)))
    pipe = PersistencePipeline("shardmap", n_blocks=4, distributed=False,
                               device="cpu")
    got = pipe.run(TopoRequest(field=f, grid=Grid.of(*dims)))
    assert got.to_bytes() == want.to_bytes()
    assert got.plan.backend == "shardmap" and not got.plan.distributed
    batch = pipe.run_batch([TopoRequest(field=f, grid=Grid.of(*dims))] * 2)
    assert all(r.to_bytes() == want.to_bytes() for r in batch)
    plan = pipe.lower(TopoRequest(field=ArraySource(f.reshape(dims[::-1])),
                                  chunk_z=2))
    assert plan.streamed and plan.backend == "fused" and plan.n_blocks == 4
    with pytest.raises(ValueError, match="divide"):
        PersistencePipeline("shardmap", n_blocks=3, device="cpu").run(
            TopoRequest(field=f, grid=Grid.of(*dims)))
