"""The plain reference against the port on the CPU, at small grids, and
its elder rule against Kruskal's loop."""

import numpy as np
import pytest
import torch

from bench import fields, found
from bench import reference as R


def _kruskal(n, a, b):
    parent, death = list(range(n)), [-1] * n
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        while parent[x] != x:
            x = parent[x]
        while parent[y] != y:
            y = parent[y]
        if x == y:
            continue
        x, y = min(x, y), max(x, y)
        parent[y] = x
        death[y] = i
    return death


def test_link_is_a_sphere():
    assert (len(R.NBRS), len(R.LINK_EDGES), len(R.LINK_TRIS)) == (14, 36, 24)
    betti, _ = R.tables("cpu")
    assert betti[R.FULL].tolist() == [1, 0, 1]


@pytest.mark.parametrize("seed", range(6))
def test_elder_rule_is_kruskal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    m = int(rng.integers(0, 1200))
    a = torch.as_tensor(rng.integers(0, n, m))
    b = (a + torch.as_tensor(rng.integers(-9, 10, m))).clamp(0, n - 1)
    death, _ = R.elder_rule(n, a, b)
    assert death.tolist() == _kruskal(n, a, b)


def test_vertex_ranks_break_ties_by_id():
    f = torch.tensor([0.5, -0.0, 0.0, -1.0, 0.5])
    assert R.vertex_ranks(f).tolist() == [3, 1, 2, 0, 4]


@pytest.mark.parametrize("dims,seed,noise", [((16, 16, 16), 1, 0.05),
                                             ((20, 12, 24), 3, 0.05),
                                             ((24, 24, 24), 2**31 + 7, 0.01)])
def test_reference_equals_port(dims, seed, noise):
    from repro_torch.core.grid import Grid
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.pipeline import api
    f = fields.make({"formula": "isabel", "noise": noise}, dims, seed, 0,
                    seed % 8, "cpu")
    check = found.load("checks", "d0")
    caught = []
    scatter = api.scatter_results_batch

    def catching(*a, **kw):
        caught.extend(scatter(*a, **kw))
        return caught
    api.scatter_results_batch = catching
    try:
        res = PersistencePipeline("fused", device="cpu").run(
            TopoRequest(field=f, grid=Grid.of(*dims), homology_dims=(0,)))
    finally:
        api.scatter_results_batch = scatter
    got = check.compare(f, dims, check.program(res, caught[0]))
    assert {k: v for k, (v, _) in got.items()} == dict.fromkeys(
        check.LIMITS, 0)
    ref = R.d0_reference(f, dims)
    assert len(ref.pairs) == ref.n_critical[0] - 1
    assert ref.n_critical == {k: res.stats[f"n_critical_d{k}"]
                              for k in range(4)}
    assert ref.essential.tolist() == [int(torch.argmin(f))]
