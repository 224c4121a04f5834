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


@pytest.mark.parametrize("backend", ["fused", "prepass"])
def test_cuda_run_matches_cpu_run(cuda, backend):
    dims = (24, 20, 16)
    f = make_field("random", dims, seed=1)
    req = TopoRequest(field=f, grid=Grid.of(*dims))
    gpu = PersistencePipeline(backend).run(req)
    cpu = PersistencePipeline(backend, device="cpu").run(req)
    for key, arr in cpu.arrays().items():
        np.testing.assert_array_equal(gpu.arrays()[key], arr, err_msg=key)
