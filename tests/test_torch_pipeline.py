"""PyTorch port, whole slice: ``repro_torch.pipeline.PersistencePipeline``
on the CPU against ``repro.pipeline.PersistencePipeline(backend="jax",
sandwich_backend="jax")`` — ``pairs`` in value and order space,
``essential``, ``betti`` and the raw diagrams, bit for bit, for 3-D, 2-D
and 1-D grids and ``run_batch``; one field against the boundary-matrix
oracle; the request surface; and the import rule (no jax, no repro)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import grid as JG
from repro.core.diagram import Diagram as JDiagram
from repro.core.diagram import diff_report, same_offdiagonal
from repro.core.dms import oracle_to_diagram
from repro.core.reduction import compute_oracle
from repro.fields.generators import make_field as j_make_field
from repro.pipeline import PersistencePipeline as JPipeline
from repro.pipeline import TopoRequest as JRequest

import repro_torch
from repro_torch.core.dms import compute_dms
from repro_torch.core.grid import Grid
from repro_torch.fields.generators import FIELDS, make_field
from repro_torch.pipeline import (PersistencePipeline, TopoRequest,
                                  UnknownBackendError, available_backends)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _reference(f, dims, **req):
    return JPipeline(backend="jax", sandwich_backend="jax").run(
        JRequest(field=f, grid=JG.Grid.of(*dims), **req))


def _port(f, dims, backend="fused", **req):
    return PersistencePipeline(backend, device="cpu").run(
        TopoRequest(field=f, grid=Grid.of(*dims), **req))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(want, got, tag):
    assert got.homology_dims == want.homology_dims, tag
    for p in want.homology_dims:
        for space in ("value", "order"):
            np.testing.assert_array_equal(got.pairs(p, space=space),
                                          want.pairs(p, space=space),
                                          err_msg=f"{tag} pairs {p} {space}")
            np.testing.assert_array_equal(
                got.essential(p, space=space),
                want.essential(p, space=space),
                err_msg=f"{tag} essential {p} {space}")
    assert got.betti() == want.betti(), tag
    for kind in ("pairs", "essential"):
        a, b = getattr(want.diagram, kind), getattr(got.diagram, kind)
        assert sorted(a) == sorted(b), (tag, kind)
        for k in a:
            np.testing.assert_array_equal(_np(b[k]), _np(a[k]),
                                          err_msg=f"{tag} {kind}[{k}]")


@pytest.mark.parametrize("name,dims", [
    ("wavelet", (8, 8, 8)), ("random", (8, 8, 8)), ("isabel", (7, 6, 9)),
    ("magnetic", (5, 9, 3)), ("random", (12, 10, 1)), ("pressure", (9, 4, 1)),
    ("random", (16,)), ("elevation", (4, 1, 1))])
def test_run_matches_reference(name, dims):
    f = make_field(name, dims, seed=3)
    _assert_same(_reference(f, dims), _port(f, dims), (name, dims))


@pytest.mark.parametrize("backend", ["prepass", "torch"])
def test_other_gradient_backends_match_reference(backend):
    dims = (6, 5, 7)
    f = make_field("random", dims, seed=4)
    _assert_same(_reference(f, dims), _port(f, dims, backend=backend),
                 backend)


def test_run_batch_matches_reference():
    dims = (6, 5, 4)
    fields = [make_field(n, dims, seed=s) for n, s in
              (("random", 0), ("wavelet", 1), ("magnetic", 2))]
    nx, ny, nz = dims
    got = PersistencePipeline(device="cpu").run_batch(
        [TopoRequest(field=f.reshape(nz, ny, nx)) for f in fields])
    assert [r.report.children[1].counters["batch_size"] for r in got] == \
        [3, 3, 3]
    for f, res in zip(fields, got):
        _assert_same(_reference(f, dims), res, "batch")


def test_run_batch_mixed_shapes_keep_order():
    a = make_field("random", (5, 4, 3), seed=1).reshape(3, 4, 5)
    b = make_field("random", (4, 4, 4), seed=2).reshape(4, 4, 4)
    got = PersistencePipeline(device="cpu").run_batch(
        [TopoRequest(field=a), TopoRequest(field=b), TopoRequest(field=a)])
    assert [r.grid_dims for r in got] == [(5, 4, 3), (4, 4, 4), (5, 4, 3)]
    _assert_same(got[0], got[2], "same field twice")


def test_query_options_match_reference():
    dims = (8, 7, 6)
    f = make_field("random", dims, seed=6)
    want = _reference(f, dims, min_persistence=0.5, top_k=7,
                      homology_dims=(0, 1))
    got = _port(f, dims, min_persistence=0.5, top_k=7, homology_dims=(0, 1))
    _assert_same(want, got, "query options")
    assert got.plan.stage_names == want.plan.stage_names
    np.testing.assert_array_equal(got.pairs(1, top_k=2),
                                  want.pairs(1, top_k=2))


def test_diagram_matches_boundary_matrix_oracle():
    dims = (6, 6, 6)
    f = make_field("random", dims, seed=7)
    jg = JG.Grid.of(*dims)
    orc = oracle_to_diagram(compute_oracle(jg, f), jg)
    got = compute_dms(Grid.of(*dims), f, device="cpu").diagram
    mine = JDiagram(jg, got.order.numpy(),
                    {k: v.numpy() for k, v in got.pairs.items()},
                    {k: v.numpy() for k, v in got.essential.items()})
    assert same_offdiagonal(orc, mine), diff_report(orc, mine,
                                                    ("oracle", "port"))
    for p in range(jg.dim + 1):
        np.testing.assert_array_equal(mine.essential_orders(p),
                                      orc.essential_orders(p))


def test_field_generators_are_the_reference():
    dims = (7, 5, 3)
    for name in FIELDS:
        np.testing.assert_array_equal(make_field(name, dims, seed=9),
                                      j_make_field(name, dims, seed=9),
                                      err_msg=name)


def test_torch_tensor_field_and_grid_inference():
    f = make_field("wavelet", (6, 5, 4), seed=0)
    a = PersistencePipeline(device="cpu").run(
        torch.from_numpy(f.reshape(4, 5, 6)))
    b = _port(f, (6, 5, 4))
    assert a.grid_dims == (6, 5, 4)
    _assert_same(b, a, "tensor field")


def test_lower_describes_the_plan():
    pipe = PersistencePipeline(device="cpu")
    f = np.zeros((3, 4, 5), np.float32)
    plan = pipe.lower(TopoRequest(field=f, homology_dims=(0,)))
    assert plan.stage_names == ("order", "gradient", "extract_sort", "d0")
    assert "backend='fused'" in plan.describe() and "cpu" in plan.describe()
    assert pipe.lower(f).stage_names[-3:] == ("d0", "d_top", "d1")
    assert hash(plan.key) == hash(pipe.lower(
        TopoRequest(field=f, homology_dims=(0,))).key)


@pytest.mark.parametrize("option", [
    dict(stream=True, n_blocks=2), dict(chunk_z=2, distributed=True),
    dict(n_blocks=2), dict(distributed=True)])
def test_later_slice_options_raise(option):
    """The options a later slice brought (the distributed engines, in
    memory and streamed) run on the CPU and give the reference's payload
    and distributed counters."""
    dims = (3, 4, 6)
    f = make_field("random", dims, seed=5)
    got = _port(f, dims, **option)
    want = _reference(f, dims, **option)
    assert got.to_bytes() == want.to_bytes()
    assert got.plan.distributed == want.plan.distributed
    for k in ("d0_rounds", "d_top_rounds", "d1_rounds", "d1_token_hops",
              "n_blocks"):
        assert got.stats.get(k) == want.stats.get(k), k


@pytest.mark.parametrize("option", [
    # a deadline long enough never to bind: where the walk stops under a
    # binding deadline depends on each package's speed, not on the code
    dict(epsilon=0.1), dict(progressive=True), dict(deadline_s=1e3),
    dict(trace=True), dict(cache=True)])
def test_approx_cache_trace_options_match_reference(option):
    """The options ported with approximation, the cache and tracing run
    on the CPU and give the reference's payload."""
    dims = (7, 6, 5)
    f = make_field("isabel", dims, seed=4)
    got = _port(f, dims, **option)
    want = _reference(f, dims, **option)
    assert got.to_bytes() == want.to_bytes()
    assert got.error_bound == want.error_bound
    assert (got.trace is None) == (want.trace is None)


def test_request_validation():
    pipe = PersistencePipeline(device="cpu")
    with pytest.raises(ValueError, match="flat field"):
        pipe.run(np.zeros(60, np.float32))
    with pytest.raises(ValueError, match="conflict"):
        pipe.run(TopoRequest(field=np.zeros((3, 4, 5)), grid=Grid.of(3, 4, 5)))
    with pytest.raises(TypeError):
        pipe.run(TopoRequest(field=np.zeros((3, 4, 5))), top_k=3)
    with pytest.raises(UnknownBackendError):
        PersistencePipeline("pallas", device="cpu")
    assert set(available_backends()) == {"fused", "prepass", "torch",
                                         "shardmap", "np"}


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PersistencePipeline()


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.pipeline, "
            "repro_torch.kernels.sandwich, repro_torch.kernels.build, "
            "repro_torch.fields.generators, repro_torch.core.dms, "
            "repro_torch.approx, repro_torch.cache, repro_torch.serve, "
            "repro_torch.distributed.d1_rounds, "
            "repro_torch.distributed.pairing_rounds, repro_torch.core.ddms, "
            "repro_torch.core.reduction\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_port_sources_import_nothing_of_jax_or_repro():
    root = os.path.dirname(repro_torch.__file__)
    paths = [os.path.join(d, n) for d, _, ns in os.walk(root) for n in ns
             if n.endswith(".py")]
    paths.append(os.path.join(os.path.dirname(SRC), "chip_smoke.py"))
    for path in paths:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "jaxlib", "repro"), (path, line)
