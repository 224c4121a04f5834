"""PyTorch port on a card: both CUDA kernels (and the fused kernel's halo
entry) bit-equal to the plain PyTorch version, and the pipeline on the
card (in memory and streamed) equal to the pipeline on the CPU.  Every
test here is marked ``cuda`` and skips without a CUDA device; the file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.gradient import neighbor_orders
from repro_torch.core.grid import Grid, vertex_order
from repro_torch.fields.generators import make_field
from repro_torch.kernels import lower_star as LS
from repro_torch.kernels import ops, ref
from repro_torch.pipeline import PersistencePipeline, TopoRequest
from repro_torch.stream import (ArraySource, pack_value_keys_torch,
                                plan_chunks)
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
