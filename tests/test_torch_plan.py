"""PyTorch port, multi-device planning II: ``repro_torch.launch.roofline``
and ``repro_torch.launch.dryrun`` on the CPU.

Held: ``model_flops`` equal to the reference's for every architecture,
shape and mesh size; per-device argument bytes equal to the sum derived
from the reference's own specs (``repro.train.sharding``) for training and
decoding on both production meshes; the cost counter's FLOPs of a dense
smoke step equal to a hand count from its shapes (prefill and a train step
with remat); the ``k1``/``k2`` extrapolation equal to a direct count at the
full depth; no collective on a (1, 1) mesh, and each collective kind on a
hand-computed case; the link rule; the DDMS plan's per-block argument and
output bytes equal to the arrays ``run_front`` returns at a small grid in 2
and 4 blocks; and records of full-width cells that ``benchmarks/report.py``
renders.  Counts are integers of shapes: every comparison is exact, except
the extrapolation's, which is affine arithmetic on floats (relative 1e-12);
and the DDMS plan's per-block peak (argument + output + temp) times the
block count within relative 1e-3 of the peak live bytes the cost counter
counts over ``run_front`` on real CPU tensors.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS, get_config as j_get_config
from repro.configs.registry import input_specs as j_input_specs
from repro.launch import roofline as JRL
from repro.models import transformer as JT
from repro.models.config import SHAPES as J_SHAPES
from repro.train import sharding as JSH

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.train import sharding as SH
from repro_torch.train.train_step import StepConfig

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
UNIT = {"data": 1, "model": 1}


class _RefMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _ref_devices(spec, sizes):
    n = 1
    for part in tuple(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            n *= sizes[a]
    return n


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_reference(arch):
    for name, shape in SHAPES.items():
        for n in (1, 256, 512):
            assert RL.model_flops(get_config(arch), shape, n) == \
                JRL.model_flops(j_get_config(arch), J_SHAPES[name], n)


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_from_reference_specs(arch, mesh_kind, shape_name):
    sizes = MESHES[mesh_kind]
    batch = ("pod", "data") if mesh_kind == "multi" else ("data",)
    jcfg, shape = j_get_config(arch), J_SHAPES[shape_name]
    jrules = JSH.ShardingRules(batch_axes=batch)
    specs = dict(_flat(JSH.param_specs(JT.lm_meta(jcfg), jrules,
                                       _RefMesh(sizes))))
    meta = dict(_flat(JT.lm_meta(jcfg)))
    params = sum(math.prod(meta[p].shape) * 4 / _ref_devices(s, sizes)
                 for p, s in specs.items())
    bsize = math.prod(sizes[a] for a in batch)
    if shape.kind == "train":
        want = 3 * params + 4
        for v in j_input_specs(jcfg, shape).values():
            n = math.prod(v.shape) * np.dtype(v.dtype).itemsize
            want += n / (bsize if v.shape[0] % bsize == 0 else 1)
    else:
        import jax
        cache = jax.eval_shape(lambda: JT.init_cache(
            jcfg, shape.global_batch, shape.seq_len))
        cspecs = dict(_flat(JSH.cache_specs(jcfg, cache, jrules,
                                            _RefMesh(sizes))))
        want = params + sum(
            math.prod(x.shape) * np.dtype(x.dtype).itemsize
            / _ref_devices(cspecs[p], sizes) for p, x in _flat(cache))
        want += shape.global_batch * 4 / bsize
    rules = SH.ShardingRules(batch_axes=batch)
    got, static = D.argument_bytes(get_config(arch), SHAPES[shape_name],
                                   sizes, rules)
    assert got == pytest.approx(want, rel=1e-12)
    assert static == pytest.approx(
        params * (4 if shape.kind == "train" else 1), rel=1e-12)


def _dense_hand_flops(cfg, B, S):
    """Matmul FLOPs of one forward of a dense GQA stack (materialized
    attention): per layer q, k, v, o projections, logits and weighted
    values, the gated MLP; then the unembedding."""
    T_ = B * S
    d, H, Kv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    layer = (2 * T_ * d * (H * hd + 2 * Kv * hd) + 2 * T_ * H * hd * d
             + 2 * 2 * B * H * S * S * hd + 3 * 2 * T_ * d * F)
    return cfg.n_layers * layer, 2 * T_ * d * cfg.vocab_padded


def test_counted_flops_equal_hand_count():
    cfg = smoke_config("minitron-4b")
    rules = SH.ShardingRules()
    B, S = 2, 32
    blocks, unembed = _dense_hand_flops(cfg, B, S)
    pre = D.count_step(cfg, ShapeSpec("t", S, B, "prefill"), UNIT, rules)
    assert pre["flops"] == blocks + unembed
    # train with remat: the blocks' forward twice (the recompute), every
    # product's two input gradients in the backward (the embedded input
    # requires grad, so the first layer's too); the recompute stops early,
    # once it has every tensor the backward saved, so the last product of
    # each block (the MLP's down projection) runs once
    tr = D.count_step(cfg, ShapeSpec("t", S, B, "train"), UNIT, rules,
                      StepConfig(remat=True))
    wd = 2 * B * S * cfg.d_ff * cfg.d_model
    assert tr["flops"] == 4 * blocks + 3 * unembed - cfg.n_layers * wd
    plain = D.count_step(cfg, ShapeSpec("t", S, B, "train"), UNIT, rules,
                         StepConfig(remat=False))
    assert plain["flops"] == 3 * blocks + 3 * unembed
    assert tr["peak"] < plain["peak"]
    assert pre["constraints"] == cfg.n_layers + 2


def test_peak_extrapolation_follows_the_phase_that_holds_it():
    # at a few layers the backward holds a mamba2 train step's peak, at 24
    # the optimizer (the gradients and one stacked leaf's temporary): a
    # line through the two shallow peaks misses the deep one; the phase
    # by phase extrapolation equals the direct count
    cfg = dataclasses.replace(smoke_config("mamba2-2.7b"), n_layers=24)
    shape = ShapeSpec("t", 16, 2, "train")
    rules, step = SH.ShardingRules(), StepConfig(remat=True)
    costs, detail = D._exact_costs(cfg, shape, UNIT, rules, step,
                                   exact=False)
    direct = D.count_step(cfg, shape, UNIT, rules, step)
    shallow = D.count_step(dataclasses.replace(cfg, n_layers=detail["k1"]),
                           shape, UNIT, rules, step)
    held_by = [max(range(len(r["lives"])), key=lambda i: max(r["lives"][i]))
               for r in (shallow, direct)]
    assert held_by == [1, 2]
    assert costs["peak"] == pytest.approx(direct["peak"], rel=1e-12)
    a, b = (m["peak"] for m in detail["measured"])
    per = (b - a) / (detail["k2"] - detail["k1"])
    assert a + (cfg.n_layers - detail["k1"]) * per < 0.99 * direct["peak"]


@pytest.mark.parametrize("arch,kind,axes", [
    ("minitron-4b", "train", ("data",)),
    ("mamba2-2.7b", "train", ("data",)),
    ("dbrx-132b", "prefill", ("data",)),
    ("zamba2-7b", "decode", ("data",)),
    ("minitron-4b", "train", ("pod", "data"))])
def test_batch_axes_split_equals_a_count_at_the_local_batch(arch, kind,
                                                             axes):
    # without FSDP and with a model axis of 1 a device holds every leaf
    # whole and runs the step on its share of the batch: its bytes, peak
    # and output equal a count of that batch on one device, and the
    # global FLOPs are the device's times the batch devices
    cfg = smoke_config(arch)
    mesh = dict({a: 2 for a in axes}, model=1)
    nb = 2 ** len(axes)
    rules = SH.ShardingRules(batch_axes=axes, fsdp=False)
    got = D.count_step(cfg, ShapeSpec("t", 16, 2 * nb, kind), mesh, rules)
    one = D.count_step(cfg, ShapeSpec("t", 16, 2, kind), UNIT,
                       SH.ShardingRules(fsdp=False))
    assert got["flops"] == nb * one["flops"]
    for key in ("bytes", "peak", "output"):
        assert got[key] == one[key], key


@pytest.mark.parametrize("kind,remat", [("train", True), ("train", False),
                                        ("prefill", False),
                                        ("decode", False)])
def test_model_axis_split_equals_a_count_of_the_local_shapes(kind, remat):
    # tensor parallelism over model = 2: a device runs the dense step with
    # half the heads, kv heads, MLP width and vocabulary; its FLOPs, bytes,
    # peak and output equal a count of that local model on one device.
    # Shares are inferred from sizes (dryrun._Shares), so the sizes here
    # are chosen to coincide with none the plan shards (its stated limit)
    cfg = dataclasses.replace(smoke_config("minitron-4b"), n_heads=8,
                              n_kv=4, head_dim=20, vocab=4096)
    local = dataclasses.replace(cfg, n_heads=4, n_kv=2, d_ff=cfg.d_ff // 2,
                                vocab=2048)
    shape = ShapeSpec("t", 50, 3, kind)
    step = StepConfig(remat=remat)
    got = D.count_step(cfg, shape, {"data": 1, "model": 2},
                       SH.ShardingRules(), step)
    one = D.count_step(local, shape, UNIT, SH.ShardingRules(), step)
    assert got["flops"] == 2 * one["flops"]
    for key in ("bytes", "peak", "output"):
        assert got[key] == one[key], key


def test_constrained_spec_sets_the_share_of_its_shape():
    # an annotated activation's spec divides its own storage (allocated
    # before the annotation) and every later tensor of its shape, and its
    # views take their storage's share
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = smoke_config("minitron-4b")
    mesh = {"data": 1, "model": 2}
    rules = SH.ShardingRules(seq_shard=True)
    meta = D.T.lm_meta(cfg)
    share = D._Shares(cfg, ShapeSpec("t", 12, 3, "train"),
                      list(zip(D._leaves(meta),
                               D._leaves(SH.param_specs(meta, rules,
                                                        mesh)))),
                      mesh, rules)
    with FakeTensorMode():
        a = torch.zeros(3, 12, cfg.d_model)
        with D.CostCounter(share) as cc:
            x = a + 1
            assert cc.live == x.nbytes
            cc.constrained(x, "tokens", SH.P("data", "model"))
            assert cc.live == x.nbytes / 2 and cc.constraints == 1
            y = x * 2
            assert cc.live == x.nbytes
            b0 = cc.bytes
            y.reshape(36, cfg.d_model).sum()
            # the view read at its storage's share (1/2), its 4-byte sum
            assert cc.bytes - b0 == x.nbytes / 2 + 4


@pytest.mark.parametrize("arch,kind", [("mamba2-2.7b", "train"),
                                       ("minitron-4b", "prefill"),
                                       ("zamba2-7b", "decode"),
                                       ("whisper-medium", "train")])
def test_extrapolation_equals_full_depth_count(arch, kind):
    cfg = smoke_config(arch)
    k1, k2 = D._variant_layer_counts(cfg)
    kw = dict(n_layers=k2 + k1)
    if cfg.enc_dec:
        kw["enc_layers"] = k2 + k1
    cfg = dataclasses.replace(cfg, **kw)
    shape = ShapeSpec("t", 16, 2, kind)
    rules = SH.ShardingRules()
    costs, detail = D._exact_costs(cfg, shape, UNIT, rules, StepConfig(),
                                   exact=False)
    assert [m["ops"] for m in detail["measured"]][0] > 0
    direct = D.count_step(cfg, shape, UNIT, rules)
    for key in ("flops", "bytes", "peak", "output"):
        assert costs[key] == pytest.approx(direct[key], rel=1e-12), key


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_no_collective_on_a_unit_mesh(arch):
    cfg = get_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("t", 4096, 256, kind)
        c = RL.collective_bytes(RL.lm_collectives(
            cfg, shape, UNIT, SH.ShardingRules()), UNIT)
        assert c["count"] == 0 and c["seconds"] == 0
        assert not any(c[k] for k in RL._COLLECTIVES)
    from repro_torch.distributed.shardmap_pipeline import FrontConfig
    fc = FrontConfig((64, 64, 64), 1)
    c = RL.collective_bytes(RL.ddms_collectives(fc, {"data": 1}),
                            {"data": 1})
    assert c["count"] == 0


def test_collectives_by_kind_hand_cases():
    """A dense and an MoE smoke config on (data=2, model=2), train with
    remat (3 passes), B=4, S=8: t = 16 tokens per device."""
    mesh = {"data": 2, "model": 2}
    rules = SH.ShardingRules()
    shape = ShapeSpec("t", 8, 4, "train")
    cfg = smoke_config("minitron-4b")       # d 64, H 4, Kv 2, hd 16, F 128
    ent = RL.lm_collectives(cfg, shape, mesh, rules, remat=True)
    d, L_, t, p = 64, cfg.n_layers, 16, 3
    # wq (L, d, H, hd): embed on data, heads on model -> gathered shard
    # L*d*H*hd/2 bf16, three times; its f32 gradient reduce-scattered
    wq = L_ * d * 4 * 16
    assert ("all-gather", p * wq * 2 / 2, ("data",)) in ent
    assert ("reduce-scatter", wq * 4 / 4, ("data",)) in ent
    # ln_f (d,): embed on data -> gathered whole; nothing on the model axis
    assert ("all-gather", p * d * 2, ("data",)) in ent
    # row-parallel wo and wd: p x layers x t x d x 2 B over the model axis
    ar = [e for e in ent if e[0] == "all-reduce" and e[2] == ("model",)]
    row = p * L_ * t * d * 2
    # wo, wd, the embedding lookup, the vocab-sharded logits (unembed)
    assert sorted(b for _, b, _ in ar) == sorted(
        [row, row, t * d * 2, 2 * p * t * 4])
    c = RL.collective_bytes(ent, mesh)
    assert c["count"] == len(ent)
    # data (strides 2) is not trailing: InfiniBand; model: NVLink
    assert c["seconds"] == pytest.approx(
        sum(b for _, b, a in ent if a == ("data",)) / RL.IB_BW
        + sum(b for _, b, a in ent if a == ("model",)) / RL.NVLINK_BW)
    # replicated over data (fsdp off): DP all-reduce of the f32 gradient
    nofsdp = RL.lm_collectives(cfg, shape, mesh,
                               SH.ShardingRules(fsdp=False), remat=True)
    assert ("all-reduce", wq * 4 / 2, ("data",)) in nofsdp
    assert not [e for e in nofsdp if e[0] in ("all-gather",
                                              "reduce-scatter")]
    # experts on the model axis: 2 all-to-alls per MoE layer and pass
    moe = smoke_config("moonshot-v1-16b-a3b")
    a2a = [e for e in RL.lm_collectives(moe, shape, mesh, rules)
           if e[0] == "all-to-all"]
    mo = moe.moe
    assert len(a2a) == 2 * p * moe.n_layers
    assert a2a[0][1] == mo.capacity_factor * t * mo.top_k * moe.d_model * 2
    # the DDMS ring: halo planes, the tet ghost segment, ring shifts
    from repro_torch.distributed.shardmap_pipeline import FrontConfig
    fc = FrontConfig((8, 4, 16), 4, ring_rotations=2)
    dd = RL.ddms_collectives(fc, {"data": 4})
    P_ = 32
    perm = sorted(b for k, b, _ in dd if k == "collective-permute")
    assert perm == sorted([P_ * 8] * 2 + [P_ * 6 * 8]
                          + [2 * P_ * 8] * (2 * 4)
                          + [2 * P_ * 6 * 8] * (2 * 4))
    cap = math.ceil(2.0 * fc.nv_local / 4) * 4
    assert [b for k, b, _ in dd if k == "all-to-all"] == [cap * 16] * 2


def test_link_rule():
    assert RL.link_bandwidth(MESHES["single"], ("model",)) == RL.IB_BW
    assert RL.link_bandwidth(MESHES["single"], ("data",)) == RL.IB_BW
    assert RL.link_bandwidth({"data": 32, "model": 8}, ("model",)) == \
        RL.NVLINK_BW
    assert RL.link_bandwidth({"data": 32, "model": 8}, ("data",)) == \
        RL.IB_BW
    assert RL.link_bandwidth({"data": 8}, ("data",)) == RL.NVLINK_BW
    assert RL.link_bandwidth({"data": 256}, ("data",)) == RL.IB_BW
    assert RL.io_bytes(10, 4, False, ghosts=3) == 10 * 4 + 3 * 4 + 10 * 153
    assert RL.io_bytes(10, 8, True) == 10 * 8 * 28 + 10 * 153


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_ddms_block_bytes_equal_run_front_outputs(n_blocks):
    from repro_torch.distributed.shardmap_pipeline import (REPLICATED,
                                                           run_front)
    from repro_torch.fields.generators import make_field
    dims = (6, 5, 8)
    f = make_field("random", dims, seed=0)
    fc, out = run_front(dims, f, n_blocks, device="cpu")
    blocked = sum(v.numel() * v.element_size() for k, v in out.items()
                  if k not in REPLICATED)
    rep = sum(v.numel() * v.element_size() for k, v in out.items()
              if k in REPLICATED)
    plan = D.ddms_block_bytes(fc)
    assert blocked % n_blocks == 0
    assert plan["output"] == blocked // n_blocks + rep
    assert plan["argument"] == fc.nv_local * 4
    rec = D.plan_ddms(dims, {"data": n_blocks}, crit_cap=None,
                      ring_rotations=None)
    assert rec["memory_analysis"]["output_size_in_bytes"] == plan["output"]
    assert rec["bytes_per_device"] == sum(plan["passes"].values())
    assert rec["config"]["kernel_rank_bytes"] == 4


@pytest.mark.parametrize("kw", [dict(sort_slack=2.0), dict(sort_slack=4.0),
                                dict(sort_slack=16.0),
                                dict(use_sample_sort=False)])
def test_ddms_planned_peak_equals_a_counted_run_front(kw, monkeypatch):
    """``n_blocks x (argument + output + temp)`` within 1e-3 of the peak
    live bytes ``CostCounter`` counts over ``run_front`` on real CPU
    tensors (``isabel`` 24 x 24 x 16 in 4 blocks, the triplet capacity
    apart from the block's vertex count; at slack 16 the sample sort holds
    the peak, else the tet table's ring resolution).  The card's halo
    entry allocates only its rows (and the int32 copy of the volume); the
    plain version CPU tensors run holds far more, so the count runs it
    outside the counter and allocates the kernel's outputs inside it."""
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.distributed import shardmap_pipeline as SP
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS

    def halo_entry(ext, *, rank_bound=None):
        ext = LS._maybe_int32(ext, rank_bound)
        with _disable_current_modes():
            rows = LS.fused_rows_from_halo_volume(ext, rank_bound=rank_bound)
        outs = LS._outputs(rows[0].shape[0], ext.device)
        for o, r in zip(outs, rows):
            o.copy_(r)
        return outs

    monkeypatch.setattr(SP, "fused_rows_from_halo_volume", halo_entry)
    dims, nb = (24, 24, 16), 4
    f = torch.from_numpy(make_field("isabel", dims, seed=0))
    cc = D.CostCounter()
    # some 17k small ops: one intra-op thread keeps them from waiting on
    # a thread pool that shares the cores with other test processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with cc:
            fc, out = SP.run_front(dims, f, nb, device="cpu", **kw)
    finally:
        torch.set_num_threads(threads)
    blk = D.ddms_block_bytes(fc)
    planned = nb * (blk["argument"] + blk["output"] + blk["temp"])
    assert abs(planned - cc.peak) <= 1e-3 * cc.peak, (planned, cc.peak)
    assert fc.crit_capacity != fc.nv_local
    held = "order" if kw.get("sort_slack") == 16.0 else "resolution"
    assert max(blk["phases"], key=blk["phases"].get) == held
    rec = D.plan_ddms(dims, {"data": nb}, crit_cap=None, ring_rotations=None,
                      **kw)
    assert sum(rec["memory_analysis"].values()) * nb == planned


def test_records_render_and_the_world_is_gone(tmp_path):
    import benchmarks.report as R
    D.run_cell("ddms:paper_6b", "field", "single", tmp_path)
    D.run_cell("mamba2-2.7b", "train_4k", "single", tmp_path)
    D.run_cell("mamba2-2.7b", "long_500k", "single", tmp_path,
               skip_existing=False)
    assert not dist.is_initialized()
    recs = R.load(tmp_path)
    assert len(recs) == 3 and not [r for r in recs if "error" in r]
    by = {r["arch"]: r for r in recs if r["shape"] != "long_500k"}
    ddms = by["ddms:paper_6b"]
    assert ddms["n_devices"] == 256 and ddms["shape"] == "2048x1920x1536"
    # one block: 6 planes of 2048 x 1920, 4 B of f32 each
    assert ddms["memory_analysis"]["argument_size_in_bytes"] == \
        6 * 2048 * 1920 * 4
    lm = by["mamba2-2.7b"]
    assert lm["dominant"] in ("compute", "memory", "collective")
    assert 4 * lm["param_bytes_global"] / 256 <= \
        lm["static_bytes_per_device"] < 4 * lm["param_bytes_global"]
    for key in ("flops_per_device", "bytes_per_device", "collectives",
                "compute_s", "memory_s", "collective_s",
                "model_flops_per_device", "useful_ratio", "memory_analysis",
                "param_bytes_global", "param_bytes_per_device_fsdp",
                "exact_detail", "scan_level_costs", "lower_s", "compile_s"):
        assert key in lm, key
    table = R.dryrun_table(recs)
    assert "mamba2-2.7b × train_4k | single | 256" in table
    assert "FAIL" not in table
    assert "ddms:paper_6b" in R.roofline_table(recs, "single")
    torch.testing.assert_close(
        lm["compute_s"], lm["flops_per_device"] / RL.PEAK_FLOPS)
