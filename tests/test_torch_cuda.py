"""PyTorch port on a card: both CUDA kernels (and the fused kernel's halo
entry) bit-equal to the plain PyTorch version, and the pipeline on the
card (in memory, streamed, approximate and served) equal to the pipeline
on the CPU.  Every
test here is marked ``cuda`` and skips without a CUDA device; the file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.approx import Hierarchy, approximate, block_minmax, refine
from repro_torch.core.gradient import neighbor_orders
from repro_torch.core.grid import Grid, vertex_order
from repro_torch.fields.generators import make_field
from repro_torch.kernels import lower_star as LS
from repro_torch.kernels import ops, ref
from repro_torch.pipeline import PersistencePipeline, TopoRequest
from repro_torch.serve import TopoService
from repro_torch.stream import (ArraySource, MemmapSource,
                                pack_value_keys_torch, plan_chunks)
from repro_torch.stream.scheduler import _ext_volume

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dims", [(5, 3, 7), (33, 17, 9), (1, 5, 6), (16,)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_kernels_match_plain(cuda, dims, dtype):
    g = Grid.of(*dims)
    f = np.random.default_rng(9).standard_normal(g.nv).astype(np.float32)
    o = vertex_order(torch.from_numpy(f).cuda()).to(dtype)
    # int64 ranks reach the kernels only when the bound forbids int32
    bound = g.nv if dtype == torch.int32 else 2 ** 40
    nb = neighbor_orders(g, o)
    want = ref.lower_star_gradient_torch(nb, o, rank_bound=g.nv)
    for got in (LS.fused_lower_star_gradient(g, o, rank_bound=bound),
                LS.lower_star_gradient_prepass(nb, o, rank_bound=bound)):
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dims,batch,dtype,offset", [
    ((129, 7, 5), 1, torch.int32, 0),          # no multiple of the tile
    ((130, 3, 2), 1, torch.int32, 0),
    ((1, 1, 300), 1, torch.int32, 0),          # nx = ny = 1
    ((1, 1, 300), 1, torch.int64, 3 << 31),
    ((7, 6, 5), 3, torch.int32, 0),            # tiles cross a member's end
    ((129, 1, 1), 3, torch.int64, 3 << 31),
    ((33, 17, 9), 1, torch.int64, 3 << 31),    # int64 ranks above 2**31
    ((40, 30, 20), 3, torch.int64, 3 << 31),
])
def test_cuda_kernels_tile_edges(cuda, dims, batch, dtype, offset):
    """Both kernels take 128 consecutive vertices per block: ragged last
    tiles, thin grids, tiles across batch members and large int64 ranks
    give the plain version's rows bit for bit."""
    g = Grid.of(*dims)
    rng = np.random.default_rng(17)
    o = torch.stack([vertex_order(torch.from_numpy(
        rng.standard_normal(g.nv).astype(np.float32)).cuda())
        for _ in range(batch)])
    want = ref.lower_star_gradient_torch(
        torch.cat([neighbor_orders(g, ob) for ob in o]), o.reshape(-1),
        rank_bound=g.nv)
    o = (o + offset).to(dtype)
    nb = torch.cat([neighbor_orders(g, ob) for ob in o])
    bound = g.nv if dtype == torch.int32 else 2 ** 40
    for got in (LS.fused_lower_star_gradient(g, o, rank_bound=bound),
                LS.lower_star_gradient_prepass(nb, o.reshape(-1),
                                               rank_bound=bound)):
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert torch.equal(a, b)


def test_cuda_kernel_attrs(cuda):
    """No instantiation keeps a stack frame in local memory."""
    for name in ("fused", "prepass", "fused_halo"):
        for dtype in (torch.int32, torch.int64):
            a = LS.kernel_attrs(name, dtype)
            assert a["block"] == 128 and a["blocks_per_sm"] >= 1
            assert a["stack_bytes"] == 0, (name, dtype, a)


@pytest.mark.parametrize("backend", ["fused", "prepass"])
def test_cuda_run_matches_cpu_run(cuda, backend):
    dims = (24, 20, 16)
    f = make_field("random", dims, seed=1)
    req = TopoRequest(field=f, grid=Grid.of(*dims))
    gpu = PersistencePipeline(backend).run(req)
    cpu = PersistencePipeline(backend, device="cpu").run(req)
    for key, arr in cpu.arrays().items():
        np.testing.assert_array_equal(gpu.arrays()[key], arr, err_msg=key)


@pytest.mark.parametrize("dims,chunk_z", [
    ((33, 17, 9), 4), ((129, 7, 5), 2),        # ragged tiles
    ((1, 1, 300), 64), ((5, 3, 7), 7),         # nx = ny = 1; one chunk
    ((40, 30, 1), 1), ((17, 9, 6), 1)])        # 2-D grid; nzl = 1
def test_cuda_halo_kernel_matches_plain(cuda, dims, chunk_z):
    """The halo entry gives the plain version's rows bit for bit on every
    chunk of a field with many tied values (the vid decides), keys near
    2**62 as streaming packs them."""
    g = Grid.of(*dims)
    nx, ny, nz = g.dims
    rng = np.random.default_rng(23)
    f = rng.integers(0, 4, g.nv).astype(np.float32)
    keys = pack_value_keys_torch(torch.from_numpy(f).cuda(), 0)
    for c in plan_chunks(g.dims, chunk_z=chunk_z):
        ext = _ext_volume(keys[c.glo * nx * ny: c.ghi * nx * ny], c, g.dims)
        want = ops.lower_star_rows_halo(ext, backend="torch")
        got = LS.fused_rows_from_halo_volume(ext)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_cuda_stream_matches_cpu_stream(cuda, n_blocks):
    dims = (20, 16, 14)
    f = make_field("isabel", dims, seed=1).reshape(dims[::-1])
    req = TopoRequest(field=ArraySource(f), chunk_z=3, n_blocks=n_blocks,
                      distributed=False)
    gpu = PersistencePipeline().run(req)
    cpu = PersistencePipeline(device="cpu").run(req)
    assert gpu.to_bytes() == cpu.to_bytes()


def _zero_counts():
    for k in LS.LAUNCHES:
        LS.LAUNCHES[k] = 0
    ref.CUDA_CALLS["lower_star_gradient_torch"] = 0


@pytest.mark.parametrize("shape", [(33, 17, 9), (1, 6, 11), (1, 1, 13)])
def test_cuda_block_minmax_matches_cpu(cuda, shape):
    vol = torch.from_numpy(np.random.default_rng(3).standard_normal(shape)
                           .astype(np.float32))
    for s in range(1, 9):
        for a, b in zip(block_minmax(vol, s), block_minmax(vol, s, "cuda")):
            assert b.is_cuda and torch.equal(a, b.cpu())


def test_cuda_approximate_matches_cpu(cuda, tmp_path):
    """Every level on the card gives the CPU's payload, through the fused
    kernel (and its halo entry for a source); the plain version never
    runs on the card."""
    dims = (20, 18, 16)
    f = make_field("isabel", dims, seed=2)
    req = TopoRequest(field=f, grid=Grid.of(*dims))
    gpu, cpu = PersistencePipeline(), PersistencePipeline(device="cpu")
    h = Hierarchy(f, Grid.of(*dims), device="cuda")
    assert [lv.bound for lv in h.levels] == \
        [lv.bound for lv in Hierarchy(f, Grid.of(*dims)).levels]
    _zero_counts()
    for lv in h.levels:
        a = approximate(gpu, req, level=lv.level, hierarchy=h)
        assert a.to_bytes() == approximate(cpu, req,
                                           level=lv.level).to_bytes()
    assert LS.LAUNCHES["fused"] == len(h.levels)
    path = str(tmp_path / "f.raw")
    src = MemmapSource.write(path, f.reshape(dims[::-1]))
    a = approximate(gpu, TopoRequest(field=src, chunk_z=4), level=1)
    assert a.to_bytes() == approximate(gpu, req, level=1).to_bytes()
    assert LS.LAUNCHES["fused_halo"] >= 1
    walk = list(refine(gpu, req))
    assert walk[-1].to_bytes() == cpu.run(
        req.replace(progressive=True)).to_bytes()
    assert ref.CUDA_CALLS["lower_star_gradient_torch"] == 0


def test_cuda_service_batches_and_caches(cuda):
    dims = (12, 12, 12)
    vols = [make_field(n, dims, seed=s).reshape(dims[::-1])
            for n, s in (("random", 1), ("wavelet", 2), ("isabel", 3))]
    cpu = PersistencePipeline(device="cpu")
    with TopoService(cache=True, max_wait_s=0.5) as svc:
        _zero_counts()
        futs = [svc.submit(v) for v in vols]
        got = [f.result(timeout=120) for f in futs]
        assert LS.LAUNCHES["fused"] == 1 and svc.stats.max_batch == 3
        _zero_counts()
        again = [svc.submit(torch.from_numpy(v).cuda()).result(timeout=120)
                 for v in vols]
        assert sum(LS.LAUNCHES.values()) == 0
        assert svc.stats.cache_hits == 3
        fut = svc.submit(TopoRequest(field=vols[0], progressive=True))
        assert fut.preview.result(timeout=120).error_bound > 0
        assert fut.result(timeout=120).error_bound == 0.0
    for v, a, b in zip(vols, got, again):
        want = cpu.run(TopoRequest(field=v)).to_bytes()
        assert a.to_bytes() == b.to_bytes() == want
    assert ref.CUDA_CALLS["lower_star_gradient_torch"] == 0
