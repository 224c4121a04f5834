"""PyTorch port on a card: both CUDA kernels bit-equal to the plain
PyTorch version, and the pipeline on the card equal to the pipeline on
the CPU.  Every test here is marked ``cuda`` and skips without a CUDA
device; the file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.gradient import neighbor_orders
from repro_torch.core.grid import Grid, vertex_order
from repro_torch.fields.generators import make_field
from repro_torch.kernels import lower_star as LS
from repro_torch.kernels import ref
from repro_torch.pipeline import PersistencePipeline, TopoRequest

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
    for name in ("fused", "prepass"):
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
