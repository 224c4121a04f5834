"""PyTorch port, public surface: the names and signatures of
``repro_torch.{pipeline, serve, approx, obs, cache}`` held against the
reference's snapshot ``tests/data/api_surface.json``, and those of the LM
substrate (``repro_torch.models.{config, layers, transformer}``,
``repro_torch.configs`` and its registry, ``repro_torch.data.pipeline``,
``repro_torch.train.{optimizer, train_step, checkpoint, compression,
sharding}`` and ``repro_torch.launch.{train, mesh, roofline, dryrun}``)
against the reference's modules described live, both under the
``repro.`` -> ``repro_torch.`` renaming, with the reference's own
``describe_module``.  Every difference must be
one of ``DOCUMENTED`` (each with its reason), and every documented
difference must still be one, so the list cannot go stale."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_api_surface import MODULES, SNAPSHOT, describe_module  # noqa: E402

# difference key -> reason.  A key is "module.Name" for a name only one
# side exports, "module.Name()" for a differing signature and
# "module.Name.member" for a differing class member.
DOCUMENTED = {
    "approx.Hierarchy()": "device= in place of the JAX backend= knob",
    "approx.Hierarchy.error_field": "returns a tensor, not an ndarray",
    "approx.block_minmax()": "takes a tensor or array and device= in place "
                             "of backend=",
    "cache.fingerprint_array()": "takes an ndarray or a tensor, so no "
                                 "ndarray annotation",
    "obs.Trace.count": "a counter of the innermost sub-span scope (D0's "
                       "host syncs); the reference has no sub-spans",
    "obs.Trace.scope": "collects the device-timed sub-spans of a stage "
                       "or a run_front call",
    "obs.Trace.sub_span": "a sub-span timed on the device (CUDA events, "
                          "a profiler range); the reference times stages "
                          "on the host only",
    "pipeline.Backend()": "rows-based protocol: rows(grid, orders) in place "
                          "of gradient + batched_rows (eager, no jit)",
    "pipeline.Backend.batched_rows": "no jitted batched program: rows is "
                                     "the batched entry",
    "pipeline.Backend.gradient": "derived from rows, a method here",
    "pipeline.Backend.rows_for": "rows with the block count of a sharded "
                                 "backend",
    "pipeline.BackendCaps()": "only the capabilities the port selects on "
                              "(streamed, sharded)",
    "pipeline.BackendCaps.batched": "every port backend is batched",
    "pipeline.BackendCaps.fused": "no caller selects on it in the port",
    "pipeline.BackendCaps.jittable": "nothing is jitted in the port",
    "pipeline.PersistencePipeline()": "defaults fused / torch on cuda, a "
                                      "Backend instance accepted, device=",
    "pipeline.PersistencePipeline.lower": "tensors in place of ndarrays "
                                          "in the annotation",
    "pipeline.PersistencePipeline.run": "tensors in place of ndarrays in "
                                        "the annotation",
    "pipeline.PersistencePipeline.run_batch": "tensors in place of "
                                              "ndarrays in the annotation",
    "pipeline.PipelineState()": "tensor fields; the saddle sets are tensors",
    "pipeline.PipelineState.d0_saddles": "a tensor (None until D0), not a "
                                         "set factory",
    "pipeline.PipelineState.dual_paired_saddles": "a tensor (None until "
                                                  "the dual stage)",
    "pipeline.Plan()": "the port's fields: device, and sandwich_backend "
                       "without a default, in another order",
    "pipeline.Plan.anticipation": "a defaulted field in the port",
    "pipeline.Plan.budget": "a defaulted field in the port",
    "pipeline.Plan.distributed": "a defaulted field in the port",
    "pipeline.Plan.n_blocks": "a defaulted field in the port",
    "pipeline.Plan.streamed": "a defaulted field in the port",
    "pipeline.Plan.sandwich_backend": "a required field in the port",
    "pipeline.Plan.row_offsets": "the offset tables per (dims, device)",
    "pipeline.WIRE_MAGIC": "exported for the wire-format readers",
    "serve.generate()": "prompts an ndarray or a tensor (no ndarray "
                        "annotation), and device= (cuda unless named): "
                        "eager torch runs where the caller says",
    "models.layers.COMPUTE_DTYPE()": "torch.bfloat16, a torch.dtype, "
                                     "where JAX has a scalar type",
    "models.layers.COMPUTE_DTYPE.dtype": "torch.bfloat16 is a torch.dtype "
                                         "and has no numpy dtype member",
    "models.layers.ParamTree": "the nn.Module holding a parameter tree; "
                               "the reference's params are a plain pytree",
    "models.layers.attention_cache()": "device= (cuda unless named)",
    "models.layers.mla_cache()": "device= (cuda unless named)",
    "models.layers.mamba2_cache()": "device= (cuda unless named)",
    "models.transformer.init_cache()": "device= (cuda unless named)",
    "models.transformer.init_params()": "key an int seed or a "
                                        "torch.Generator, device= (cuda "
                                        "unless named); returns a "
                                        "ParamTree",
    "data.pipeline.batch_at()": "device= (cuda unless named): int32 "
                                "tensors on it; rows= as host_batch_at",
    "train.optimizer.Dict": "a typing name the reference imports and does "
                            "not use",
    "train.optimizer.OptState()": "step a torch.Tensor (0-d int32, on the "
                                  "host) in the annotation",
    "train.train_step.Mesh": "a jax.sharding name the reference imports "
                             "and does not use",
    "train.train_step.NamedSharding": "a jax.sharding name the reference "
                                      "imports and does not use",
    "train.train_step.P": "a jax.sharding name the reference imports and "
                          "does not use",
    "train.train_step.Optional": "a typing name the reference imports and "
                                 "does not use",
    "train.train_step.OptState": "imported by the reference, unused there",
    "train.train_step.init_opt_state": "imported by the reference, unused "
                                       "there",
    "train.train_step.loss_and_grads": "the gradient of the train step (the "
                                       "reference's value_and_grad inside "
                                       "make_train_step), public for the "
                                       "checks",
    "train.checkpoint.Any": "a typing name of the reference's shardings "
                            "annotation",
    "train.checkpoint.Tuple": "a typing name of the reference's shardings "
                              "annotation",
    "train.checkpoint.load_checkpoint()": "device= (cuda unless named), "
                                          "and shardings= (the parameters' "
                                          "placements, m and v alike) "
                                          "with mesh=",
    "train.compression.Tuple": "a typing name the reference imports and "
                               "does not use",
    "train.compression.allreduce_compressed()": "group= (a torch."
                                                "distributed process group, "
                                                "the default if None) in "
                                                "place of axis_name",
    "launch.train.batch_at()": "imported from data.pipeline: device=",
    "launch.train.mesh_batch": "a step's batch on a DeviceMesh, each rank "
                               "building its own rows (run's mesh path)",
    "launch.train.mesh_rules": "the ShardingRules of a training DeviceMesh "
                               "(run's mesh path)",
    "data.pipeline.host_batch_at()": "rows= (lo, hi): a mesh rank's rows "
                                     "of the batch alone",
    "models.layers.weight": "a parameter at use: the cast, FSDP-gathered on "
                            "a mesh (the reference leaves it to GSPMD)",
    "train.sharding.batch_rows": "the rows of a batch a mesh rank holds "
                                 "(the reference's batch is placed whole)",
    "train.sharding.gather_batch_axes": "a DTensor replicated over the "
                                        "batch axes: FSDP's gather",
    "train.sharding.init_placed": "seeded parameters made leaf by leaf and "
                                  "placed on a DeviceMesh",
    "train.sharding.mesh_device": "a mesh rank's device",
    "train.sharding.place": "jax.device_put(x, NamedSharding) for a "
                            "DeviceMesh",
    "train.sharding.place_rows": "a rank's rows of a batch input as a "
                                 "DTensor",
    "train.sharding.place_tree": "place over a tree (device_put of a tree)",
    "launch.train.load_checkpoint()": "imported from train.checkpoint: "
                                      "device=, shardings= with mesh=",
    "launch.train.run()": "device= (cuda unless named) and mesh= (a "
                          "DeviceMesh; the reference takes shardings "
                          "from its caller)",
    "train.sharding.Mesh": "jax's Mesh class: a mesh here is a torch "
                           "DeviceMesh or a mapping of axis name to size "
                           "(a type alias for checkers only)",
    "train.sharding.NamedSharding": "placements (param_shardings, "
                                    "placements) in place of NamedSharding",
    "train.sharding.P()": "the port's own partition spec, a tuple of "
                          "mesh-axis names spelled as PartitionSpec's",
    "train.sharding.P.UNCONSTRAINED": "PartitionSpec's; nothing in the "
                                      "plan is unconstrained",
    "train.sharding.P.count": "tuple's method, as P is a tuple",
    "train.sharding.P.index": "tuple's method, as P is a tuple",
    "train.sharding.P.reduced": "PartitionSpec's reduced axes: none here",
    "train.sharding.P.unreduced": "PartitionSpec's unreduced axes: none "
                                  "here",
    "train.sharding.P.update": "PartitionSpec's; specs are built whole",
    "train.sharding.axis_sizes": "axis sizes of a DeviceMesh or a mapping "
                                 "(jax's mesh.shape)",
    "train.sharding.placements": "a spec as torch.distributed.tensor "
                                 "placements, in place of NamedSharding",
    "train.sharding.set_rules()": "observe=: the planner's counter sees "
                                  "each constrained activation's spec (no "
                                  "with_sharding_constraint in eager "
                                  "torch)",
    "train.sharding.spec_devices": "the devices a spec splits a tensor "
                                   "over, for per-device bytes",
    "launch.mesh.make_field_mesh()": "device_type= (cuda unless named): a "
                                     "DeviceMesh over the default process "
                                     "group",
    "launch.mesh.make_production_mesh()": "device_type= (cuda unless "
                                          "named): a DeviceMesh over the "
                                          "default process group",
    "launch.roofline.GPUS_PER_NODE": "the H100 model: NVLink inside an "
                                     "8-GPU node",
    "launch.roofline.H100_BF16_FLOPS": "the shared kernel-bound rates "
                                       "(chip_smoke.py's)",
    "launch.roofline.H100_F32_FLOPS": "the shared kernel-bound rates",
    "launch.roofline.HBM_BYTES_PER_S": "the shared kernel-bound rates",
    "launch.roofline.INT_OPS_PER_S": "the shared kernel-bound rates",
    "launch.roofline.IB_BW": "the H100 model: InfiniBand between nodes",
    "launch.roofline.NVLINK_BW": "the H100 model: NVLink inside a node",
    "launch.roofline.ICI_BW": "no TPU interconnect: NVLINK_BW and IB_BW",
    "launch.roofline.analyze()": "takes the counted costs (no compiled "
                                 "artifact in torch) and the rate the "
                                 "FLOPs run at",
    "launch.roofline.collective_bytes()": "sums the collectives the "
                                          "sharding plan implies; the HLO "
                                          "parser is not carried over (no "
                                          "HLO in torch)",
    "launch.roofline.asdict": "a dataclasses name the reference imports "
                              "and does not use",
    "launch.roofline.field": "a dataclasses name the reference imports "
                             "and does not use",
    "launch.roofline.io_bytes": "the lower-star launch's byte count, "
                                "shared with chip_smoke.py",
    "launch.roofline.link_bandwidth": "the link a collective's axes run on",
    "launch.roofline.lm_collectives": "the LM step's collectives from the "
                                      "plan (in place of the HLO's)",
    "launch.roofline.ddms_collectives": "run_front's collectives from its "
                                        "buffers (in place of the HLO's)",
    "launch.dryrun.CostCounter": "the aten-op counter in place of XLA's "
                                 "cost and memory analyses",
    "launch.dryrun.DDMS_OPS_PER_VERTEX": "the measured integer operations "
                                         "per vertex, in place of a TPU "
                                         "guess",
    "launch.dryrun.NamedSharding": "a jax.sharding name; placements here",
    "launch.dryrun.P": "a jax.sharding name; sharding.P here",
    "launch.dryrun.argument_bytes": "argument bytes from the plan (XLA's "
                                    "memory_analysis there)",
    "launch.dryrun.count_step": "one counted step on fake tensors (a "
                                "compile there)",
    "launch.dryrun.ddms_block_bytes": "run_front's per-block arrays (XLA's "
                                      "memory_analysis there)",
    "launch.dryrun.init_opt_state": "imported by the reference, unused "
                                    "there",
    "launch.dryrun.make_field_mesh()": "imported from launch.mesh: "
                                       "device_type=",
    "launch.dryrun.make_production_mesh()": "imported from launch.mesh: "
                                            "device_type=",
    "launch.dryrun.plan_cell": "lower_cell's plan on any mesh and shape "
                               "(the (1, 1) check on the card)",
    "launch.dryrun.plan_ddms": "lower_ddms's plan on any field and block "
                               "count",
}

# the LM substrate's modules, held against the reference's live
# description (they are not in the snapshot)
LIVE_MODULES = ("repro.models.config", "repro.models.layers",
                "repro.models.transformer", "repro.configs",
                "repro.configs.registry", "repro.data.pipeline",
                "repro.train.optimizer", "repro.train.train_step",
                "repro.train.checkpoint", "repro.train.compression",
                "repro.launch.train", "repro.train.sharding",
                "repro.launch.mesh", "repro.launch.roofline",
                "repro.launch.dryrun")


def _renamed(x):
    if isinstance(x, dict):
        return {k: _renamed(v) for k, v in x.items()}
    if isinstance(x, str):
        return x.replace("repro.", "repro_torch.")
    return x


def _differences(mod: str, want: dict, got: dict) -> dict:
    """Difference keys of one module -> (reference, port) descriptions."""
    short = mod.split(".", 1)[1]
    out = {}
    for name in sorted(set(want) | set(got)):
        a, b = want.get(name), got.get(name)
        if a == b:
            continue
        if a is None or b is None:
            out[f"{short}.{name}"] = (a, b)
            continue
        if a.get("signature") != b.get("signature") \
                or a.get("kind") != b.get("kind"):
            out[f"{short}.{name}()"] = (a.get("signature"),
                                        b.get("signature"))
        ma, mb = a.get("members", {}), b.get("members", {})
        for m in sorted(set(ma) | set(mb)):
            if ma.get(m) != mb.get(m):
                out[f"{short}.{name}.{m}"] = (ma.get(m), mb.get(m))
    return out


@pytest.fixture(scope="module")
def differences():
    snapshot = json.loads(SNAPSHOT.read_text())
    out = {}
    for mod in MODULES:
        port = mod.replace("repro.", "repro_torch.", 1)
        out.update(_differences(mod, _renamed(snapshot[mod]),
                                describe_module(port)))
    return out


@pytest.fixture(scope="module")
def live_differences():
    # the reference's dry-run prepends a 512-device flag to XLA_FLAGS when
    # it is imported; keep it out of this process's later subprocesses
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun  # noqa: F401
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    out = {}
    for mod in LIVE_MODULES:
        out.update(_differences(mod, _renamed(describe_module(mod)),
                                describe_module(
                                    mod.replace("repro.", "repro_torch.", 1))))
    return out


def _assert_documented(differences, module):
    short = module.split(".", 1)[1] + "."
    extra = {k: v for k, v in differences.items()
             if k.startswith(short) and k not in DOCUMENTED}
    assert not extra, "undocumented surface differences:\n" + "\n".join(
        f"{k}:\n  reference: {a}\n  port:      {b}"
        for k, (a, b) in extra.items())


@pytest.mark.parametrize("module", MODULES)
def test_no_undocumented_difference(differences, module):
    _assert_documented(differences, module)


@pytest.mark.parametrize("module", LIVE_MODULES)
def test_lm_substrate_surface_matches_reference_live(live_differences,
                                                     module):
    _assert_documented(live_differences, module)


def test_no_stale_documented_difference(differences, live_differences):
    stale = sorted(set(DOCUMENTED) - set(differences)
                   - set(live_differences))
    assert not stale, f"documented differences that no longer differ: " \
                      f"{stale}"


@pytest.mark.parametrize("name", [
    "Executable", "PipelineConfig", "PipelineResult", "StreamReport",
    "default_plan_cache"])
def test_pipeline_exports_reference_names(name):
    import repro_torch.pipeline as P
    import repro.pipeline as J
    assert name in describe_module("repro_torch.pipeline")
    assert getattr(P, name).__name__ == getattr(J, name).__name__


def test_compile_diagram_diagrams_and_report():
    """The repaired surface behaves as the reference's: a second
    ``compile`` hits the plan cache, ``diagram`` / ``diagrams`` equal
    ``run``, and the report's ``to_dict`` is JSON with the reference's
    keys."""
    import numpy as np
    from repro.pipeline import PersistencePipeline as JPipeline
    from repro_torch.pipeline import (PersistencePipeline, PipelineConfig,
                                      PlanCache, TopoRequest)
    f = np.random.default_rng(0).standard_normal((4, 5, 6))
    pipe = PersistencePipeline(device="cpu", plan_cache=PlanCache())
    first = pipe.compile(f)
    hits = pipe.plan_cache.hits
    again = pipe.compile(TopoRequest(field=f))
    assert pipe.plan_cache.hits == hits + 1 and len(pipe.plan_cache) == 1
    assert again.row_offsets is first.row_offsets
    assert first.plan.compile_key == ((6, 5, 4), "fused", 1)
    assert first.plan.result_key == ((6, 5, 4), (0, 1, 2, 3))
    assert ((6, 5, 4) in pipe.plan_cache) is False and bool(PlanCache())
    res = pipe.run(TopoRequest(field=f, include_report=True))
    assert pipe.diagram(f).to_bytes() == res.to_bytes()
    assert [r.to_bytes() for r in pipe.diagrams([f, f])] == \
        [res.to_bytes()] * 2
    doc = res.report.to_dict()
    assert json.loads(json.dumps(doc)) == doc
    want = JPipeline("np").run(f, include_report=True).report.to_dict()
    assert set(doc) == set(want)
    assert [c["name"] for c in doc["children"]] == \
        [c["name"] for c in want["children"]]
    assert doc["front_seconds"] + doc["back_seconds"] == \
        pytest.approx(res.report.total_seconds)
    with pytest.raises(ValueError, match="same-shape"):
        pipe.diagrams([f, f[:2]])
    with pytest.raises(ValueError, match="n_blocks"):
        PipelineConfig(backend=pipe.backend, n_blocks=0)
    assert pipe.config.sandwich.name == "torch" and pipe.backend.name == \
        "fused"


def test_stage_report_comm_split_matches_reference():
    from repro.pipeline import StageReport as JReport
    from repro_torch.pipeline import StageReport
    docs = []
    for cls in (JReport, StageReport):
        rep = cls("pipeline")
        for name, secs in (("order", 0.5), ("gradient", 2.0), ("d1", 1.0)):
            rep.child(name).seconds = secs
        comm = rep.children[1].child("comm")
        comm.seconds = 0.25
        comm.count(comm_total_s=0.25, comm_hidden_s=0.2)
        docs.append((rep.to_dict(), rep.total_seconds, rep.comm_seconds,
                     rep.overlap_fraction))
    assert docs[0] == docs[1]
