"""PyTorch port, multi-device planning I: ``repro_torch.train.sharding`` and
``repro_torch.launch.mesh`` against the JAX package, on the CPU.

Held: the parameter specs of all ten full-width architectures equal to
the reference's on both production mesh shapes, by default, with ``fsdp``
off, with ``seq_shard`` on and with the ``{"head": "model"}`` rule; the
batch specs; the decode caches' specs at ``decode_32k`` (the reference's
caches from ``jax.eval_shape``, the port's on the ``meta`` device: nothing
full-width is allocated); ``DeviceMesh``es of 256 and 512 ranks over
torch's ``fake`` process group, whose placements give local shapes of the
global shape divided by the axis sizes; and three small repairs: ``moe``'s
per-expert counts without ``bincount``, ``fields.FIELDS``, and
``constrain`` (a no-op without rules; with them it shows the observer the
activation's spec, redistributes a ``DTensor`` to it and returns a plain
tensor unchanged).  Every comparison is exact: specs are names.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS, get_config as j_get_config
from repro.models import transformer as JT
from repro.models.config import SHAPES as J_SHAPES
from repro.train import sharding as JSH

from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch.dryrun import _fake_world
from repro_torch.models import transformer as T
from repro_torch.train import sharding as SH

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
VARIANTS = {"default": {}, "no_fsdp": {"fsdp": False},
            "seq_shard": {"seq_shard": True},
            "head_model": {"rules": {"head": "model"}}}


class _RefMesh:
    """What the reference's rules read of a mesh: ``shape`` by name."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def _rules(mod, mesh_kind, variant):
    batch = ("pod", "data") if mesh_kind == "multi" else ("data",)
    return mod.ShardingRules(batch_axes=batch, **VARIANTS[variant])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _ref_specs(arch, mesh_kind, variant):
    specs = JSH.param_specs(JT.lm_meta(j_get_config(arch)),
                            _rules(JSH, mesh_kind, variant),
                            _RefMesh(MESHES[mesh_kind]))
    return dict(_flat(specs))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh_kind, variant):
    want = _ref_specs(arch, mesh_kind, variant)
    got = dict(_flat(SH.param_specs(T.lm_meta(get_config(arch)),
                                    _rules(SH, mesh_kind, variant),
                                    MESHES[mesh_kind])))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert isinstance(got[path], SH.P)
        assert tuple(got[path]) == tuple(spec), path


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_batch_spec_matches_reference(mesh_kind, variant):
    for ndim in (1, 2, 3):
        for seq_axis in (1, 2):
            want = JSH.batch_spec(_rules(JSH, mesh_kind, variant), ndim,
                                  seq_axis)
            got = SH.batch_spec(_rules(SH, mesh_kind, variant), ndim,
                                seq_axis)
            assert tuple(got) == tuple(want), (ndim, seq_axis)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch, mesh_kind):
    shape = J_SHAPES["decode_32k"]
    jcfg = j_get_config(arch)
    jcache = jax.eval_shape(
        lambda: JT.init_cache(jcfg, shape.global_batch, shape.seq_len))
    want = dict(_flat(JSH.cache_specs(jcfg, jcache,
                                      _rules(JSH, mesh_kind, "default"),
                                      _RefMesh(MESHES[mesh_kind]))))
    cfg = get_config(arch)
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device="meta")
    got = dict(_flat(SH.cache_specs(cfg, cache,
                                    _rules(SH, mesh_kind, "default"),
                                    MESHES[mesh_kind])))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), path
    shapes = {p: tuple(x.shape) for p, x in _flat(cache)}
    assert shapes == {p: tuple(x.shape) for p, x in _flat(jcache)}


def test_spec_divisibility_fallback_and_axis_once():
    """The reference's own unit cases, on the port."""
    rules = SH.ShardingRules(batch_axes=("data",))
    mesh = MESHES["multi"]
    PM = SH.PM
    assert tuple(SH.spec_for_param(PM((5120, 40, 128), ("embed", "heads",
                                                        "head")),
                                   rules, mesh)) == ("data",)
    assert tuple(SH.spec_for_param(PM((5120, 27648), ("embed", "mlp")),
                                   rules, mesh)) == ("data", "model")
    assert tuple(SH.spec_for_param(PM((1024, 2048), ("mlp", "vocab")),
                                   rules, mesh)) == ("model",)
    head = SH.ShardingRules(batch_axes=("data",), rules={"head": "model"})
    assert tuple(SH.spec_for_param(PM((5120, 40, 128), ("embed", "heads",
                                                        "head")),
                                   head, mesh)) == ("data", None, "model")
    assert SH._axis_ok(mesh, ("pod", "data"), 64)
    assert not SH._axis_ok(mesh, ("pod", "data"), 48)


def test_placements_of_specs():
    S, R = torch.distributed.tensor.Shard, torch.distributed.tensor.Replicate
    mesh = MESHES["multi"]
    assert SH.placements(SH.P(("pod", "data"), "model"), mesh) == \
        (S(0), S(0), S(1))
    assert SH.placements(SH.P(None, "data"), mesh) == (R(), S(1), R())
    assert SH.placements(SH.P(), mesh) == (R(), R(), R())
    meta = T.lm_meta(get_config("minitron-4b"))
    rules = SH.ShardingRules(batch_axes=("pod", "data"))
    pl = dict(_flat(SH.param_shardings(meta, rules, mesh)))
    specs = dict(_flat(SH.param_specs(meta, rules, mesh)))
    assert pl.keys() == specs.keys()
    for k in pl:
        assert pl[k] == SH.placements(specs[k], mesh)


@contextlib.contextmanager
def _world(n):
    if dist.is_initialized():
        pytest.fail("a process group is already up in this worker")
    with _fake_world(n):
        yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_and_field_meshes_over_fake_world(multi_pod):
    from torch.distributed.tensor import Replicate as R, distribute_tensor
    n = 512 if multi_pod else 256
    with _world(n):
        mesh = M.make_production_mesh(multi_pod=multi_pod)
        want = MESHES["multi" if multi_pod else "single"]
        assert mesh.device_type == "cuda" and mesh.size() == n
        assert SH.axis_sizes(mesh) == want
        assert M.batch_axes_for(mesh) == (("pod", "data") if multi_pod
                                          else ("data",))
        field = M.make_field_mesh(multi_pod=multi_pod, device_type="cpu")
        assert SH.axis_sizes(field) == ({"pod": 2, "data": 256} if multi_pod
                                        else {"data": 256})
        # placements give local shapes of the shape over the axis sizes
        cpu = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = SH.ShardingRules(batch_axes=M.batch_axes_for(cpu))
        pm = SH.PM((4, 1024, 8192), ("layers", "embed", "mlp"))
        spec = SH.spec_for_param(pm, rules, cpu)
        x = torch.empty(pm.shape, device="meta")
        local = distribute_tensor(x, cpu, SH.placements(spec, cpu)) \
            .to_local().shape
        d = 32 if multi_pod else 16
        assert tuple(local) == (4, 1024 // d, 8192 // 16)
        assert tuple(spec) == (None, ("pod", "data") if multi_pod
                               else "data", "model")
        # constrain redistributes a DTensor to the activation's spec
        logits = distribute_tensor(torch.empty((64, 8, 4096), device="meta"),
                                   cpu, (R(),) * cpu.ndim)
        SH.set_rules(rules, cpu)
        try:
            out = SH.constrain(logits, "logits")
        finally:
            SH.set_rules(None, None)
        assert out.placements == SH.placements(
            SH.P(M.batch_axes_for(cpu), None, "model"), cpu)
        assert tuple(out.to_local().shape) == (64 // d, 8, 4096 // 16)


def test_mesh_raises_on_a_small_world():
    with _world(64):
        with pytest.raises(ValueError, match="need 256 ranks"):
            M.make_production_mesh()
        with pytest.raises(ValueError, match="need 512 ranks"):
            M.make_field_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="initialised"):
        M.make_production_mesh()
    assert M.batch_axes_for({"pod": 2, "data": 4, "model": 2}) == \
        ("pod", "data")


def test_moe_counts_equal_bincount():
    """``moe`` counts tokens per expert with a scatter_add_ of ones: the
    same counts as ``bincount``, and the layer's values are those the
    existing MoE tests hold against the reference."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    for E, n in ((4, 1), (16, 300), (64, 4096)):
        idx = torch.randint(0, E, (n,), generator=g)
        got = torch.zeros(E, dtype=idx.dtype).scatter_add_(
            0, idx, torch.ones_like(idx))
        assert torch.equal(got, torch.bincount(idx, minlength=E))
    cfg = smoke_config("moonshot-v1-16b-a3b")
    params = T.init_params(cfg, 0, device="cpu").tree()
    layer = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    x = torch.randn((2, 8, cfg.d_model), generator=g).to(L.COMPUTE_DTYPE)
    with torch.no_grad():
        out, aux = L.moe(cfg, layer, x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(aux) > 0


def test_fields_export():
    import repro.fields as JF
    import repro_torch.fields as F
    assert sorted(F.FIELDS) == sorted(JF.FIELDS)
    f = F.make_field("wavelet", (6, 5, 4), seed=3)
    assert np.array_equal(f, JF.make_field("wavelet", (6, 5, 4), seed=3))


def test_constrain_noop_without_rules_and_records_with():
    from repro_torch.configs import smoke_config
    seen = []

    def observe(x, kind, spec):
        seen.append((kind, tuple(x.shape), spec))

    x = torch.randn(16, 32, 64)
    assert SH.constrain(x, "tokens") is x and seen == []
    SH.set_rules(SH.ShardingRules(seq_shard=True), {"data": 16, "model": 16},
                 observe)
    try:
        assert SH.constrain(x, "tokens") is x
        y = torch.randn(16, 32, 48)
        assert SH.constrain(y, "logits") is y
        assert seen == [
            ("tokens", (16, 32, 64), SH.P("data", "model", None)),
            ("logits", (16, 32, 48), SH.P("data", None, "model"))]
        # the model's hooks: embedded inputs, each block, the logits
        cfg = smoke_config("minitron-4b")
        seen.clear()
        SH.set_rules(SH.ShardingRules(), {"data": 1, "model": 1}, observe)
        params = T.init_params(cfg, 0, device="cpu")
        with torch.no_grad():
            T.lm_apply(cfg, params, torch.zeros((1, 8), dtype=torch.long))
        kinds = [k for k, _, _ in seen]
        assert kinds == ["tokens"] * (cfg.n_layers + 1) + ["logits"]
    finally:
        SH.set_rules(None, None)
    seen.clear()
    assert SH.constrain(x, "logits") is x and seen == []
