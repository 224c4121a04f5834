"""PyTorch port, LM training over a device mesh (``repro_torch.train.
sharding``'s placements as ``DTensor``s, ``loss_and_grads``,
``adamw_update``, checkpoints and ``launch.train.run(mesh=...)``) against
the port's one-device step and against the JAX package, on the CPU.

One 4-process gloo group per module (``tests/torch_train_mesh_group.py``)
forms ``DeviceMesh("cpu")``s of shape (2, 2), (4, 1) and (1, 4).  Held, on
the reference's parameter trees (``params_from_jax``) and the data
pipeline's batch: the loss and every gathered gradient leaf of a dense,
an SSM, an MLA and a MoE architecture at each mesh equal to the one-device
step's, every rank reading the same loss; ``microbatches=2`` at (2, 2); a
3-step bf16 AdamW trajectory of ``run(mesh=...)``; a checkpoint saved by
``run`` at (2, 2) after 2 steps restoring at (4, 1), on one device and in
the JAX package with the same next-step loss; ``run`` refusing a ``cuda``
mesh without CUDA, and a mesh without a process group; and the JAX
package's own step jitted on a (2, 2) mesh of 4 forced host devices with
``NamedSharding``s from ``repro.train.sharding``, against the port's (2,
2) step, for the dense, SSM, MLA and MoE families; and the planner's per-device peak at each mesh against the mesh
step's own allocations on the CPU.

Tolerances.  A sharding is a layout: the mesh step runs the one-device
ops on local shards, joined by all-reduces, so in f32 compute it differs
from the one-device step only by the order of f32 sums, as the two
packages differ: the loss within ``F32_LOSS`` = 1e-5 and each gradient
leaf within ``F32_LEAF`` = 2e-5 of its largest magnitude, the values
``tests/test_torch_train_archs.py`` holds the packages to (the largest
seen here is 1.6e-6 of a leaf's largest magnitude, the SSM).  The bf16
trajectory within ``TRAJ_LOSS`` = 5e-3, as there.  The planner's peak
within ``PLAN_PEAK_RTOL`` = 0.10 of the step's CPU allocations, the gate
``chip_smoke.py`` holds the card's peak to (the largest seen here is
0.9 %, at (4, 1)).
"""

import contextlib
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_train_mesh_group as G  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, host_batch_at  # noqa
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.train import RunConfig, run  # noqa: E402
from repro_torch.models.config import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import abstract_params  # noqa: E402
from repro_torch.train import sharding as SH  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.pytree import tree_leaves  # noqa: E402

F32_LOSS, F32_LEAF = 1e-5, 2e-5
TRAJ_LOSS = 5e-3
PLAN_PEAK_RTOL = 0.10
HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_train_mesh_group.py")
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@contextlib.contextmanager
def compute_f32():
    """Both packages' ``COMPUTE_DTYPE`` set to f32 for the duration."""
    old = JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE
    JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE = old


@functools.lru_cache(maxsize=None)
def tree(arch):
    """The parameter tree every side loads with ``params_from_jax``
    (``G.param_tree``)."""
    return G.param_tree(arch)


def _batch(arch):
    return host_batch_at(DataConfig(smoke_config(arch).vocab, G.B, G.S), 0)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group's results (rank 0's, every rank's losses under
    ``"ranks"``), the JAX package's (2, 2) step and the checkpoint
    directory: one spawn of four ranks and one reference process."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [SRC] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    ref = subprocess.Popen([sys.executable, HELPER, "ref",
                            str(tmp / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        archs = G.ARCHS + (G.REF_ARCH,)
        inputs = tmp / "inputs.pt"
        torch.save({"trees": {a: tree(a) for a in archs},
                    "batches": {a: _batch(a) for a in archs},
                    "ckpt_dir": str(tmp / "ckpt")}, inputs)
        proc = subprocess.run([sys.executable, HELPER, "run", str(inputs),
                               str(tmp / "out.pt")], env=env, timeout=600,
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    res = torch.load(tmp / "out.pt", weights_only=False)
    res["jax"] = {a: {} for a in G.JAX_ARCHS}
    with np.load(tmp / "ref.npz") as z:
        for k in z.files:
            arch, name = k.rsplit(".", 1)
            res["jax"][arch][name] = z[k]
    res["ckpt_dir"] = tmp / "ckpt"
    return res


def one_device(arch, step_cfg=TS.StepConfig(remat=False)):
    """The port's one-device f32 (loss, metrics, gradient leaves) on the
    group's tree and batch."""
    cfg = smoke_config(arch)
    params = params_from_jax(cfg, tree(arch), device="cpu")
    with compute_f32():
        loss, m, g = TS.loss_and_grads(cfg, step_cfg, params, {
            k: torch.from_numpy(v) for k, v in _batch(arch).items()})
    return float(loss), {k: float(v) for k, v in m.items()}, \
        [x.numpy() for x in tree_leaves(g)]


def assert_close(got, want):
    """Loss within F32_LOSS, each leaf within F32_LEAF of its largest
    magnitude, the metrics as the loss."""
    (lg, mg, gg), (lw, mw, gw) = got, want
    assert abs(lg - lw) <= F32_LOSS * abs(lw), (lg, lw)
    for k in mw:
        assert abs(mg[k] - mw[k]) <= F32_LOSS * max(abs(mw[k]), 1e-3), k
    assert len(gg) == len(gw)
    for i, (a, b) in enumerate(zip(gg, gw)):
        assert a.shape == b.shape, i
        top = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= F32_LEAF * top, i


@pytest.mark.parametrize("mesh", list(G.MESHES))
@pytest.mark.parametrize("arch", G.ARCHS)
def test_mesh_step_equals_one_device(group, arch, mesh):
    """Loss, metrics and gathered gradient at the mesh equal to the
    one-device step's (f32 compute), every rank reading the same loss."""
    assert_close(group["grads"][arch, mesh], one_device(arch))
    losses = {r["losses"][arch, mesh] for r in group["ranks"]}
    assert len(losses) == 1, losses


def test_microbatches_on_mesh(group):
    """microbatches=2 at (2, 2): each slice of the global batch placed over
    the data axis again; equal to the one-device microbatched step."""
    assert_close(group["microbatches"], one_device(
        G.TRAJ_ARCH, TS.StepConfig(microbatches=2, remat=False)))
    assert len({r["losses"]["microbatches"] for r in group["ranks"]}) == 1


def test_trajectory_on_mesh(group):
    """``run(mesh=(2, 2))``, bf16, 3 AdamW steps from the seeded parameters
    (made leaf by leaf and placed): the losses follow ``run`` on one
    device, and every rank reads the same ones."""
    cfg = smoke_config(G.TRAJ_ARCH)
    _, opt, want = run(cfg, RunConfig(steps=G.TRAJ_STEPS, ckpt_every=100),
                       OptConfig(**G.OPT), TS.StepConfig(remat=False),
                       verbose=False, device="cpu")
    np.testing.assert_allclose(group["trajectory"], want, rtol=TRAJ_LOSS)
    assert group["traj_step"] == int(opt.step) == G.TRAJ_STEPS
    assert all(r["trajectory"] == group["trajectory"]
               for r in group["ranks"])


def _jax_next_loss(ckpt):
    """The JAX package's loss at the checkpoint's parameters on the batch
    of the step after it (f32 compute)."""
    cfg = j_smoke_config(G.CKPT_ARCH)
    like = tree(G.CKPT_ARCH)            # the structure only
    step, params, _ = JC.load_checkpoint(ckpt, like,
                                         JO.init_opt_state(like))
    b = JD.batch_at(JD.DataConfig(cfg.vocab, 8, 64, 0), step)
    with compute_f32():
        loss, _ = JTS.loss_fn(cfg, JTS.StepConfig(remat=False), params,
                              b["tokens"], b["labels"])
    return float(loss)


@pytest.mark.parametrize("where", ["mesh_4x1", "one_device", "jax"])
def test_checkpoint_restores_across_world_sizes(group, where):
    """A checkpoint ``run`` saved at (2, 2) after 2 steps restores at (4,
    1), on one device and in the JAX package: the next step's loss equal
    to the one-device resume's (f32 compute)."""
    cfg = smoke_config(G.CKPT_ARCH)
    ckpt = group["ckpt_dir"]
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_2"]
    with compute_f32():
        _, _, want = run(cfg, RunConfig(steps=3, ckpt_every=100,
                                        ckpt_dir=str(ckpt)),
                         OptConfig(**G.OPT), TS.StepConfig(remat=False),
                         verbose=False, device="cpu")
    assert len(want) == 1 and len(group["restore"]["first"]) == 2
    got = {"mesh_4x1": lambda: group["restore"]["resumed"][0],
           "one_device": lambda: want[0],
           "jax": lambda: _jax_next_loss(ckpt / "step_2")}[where]()
    assert abs(got - want[0]) <= F32_LOSS * abs(want[0]), (got, want)
    assert all(r["restore"] == group["restore"] for r in group["ranks"])


def test_run_refuses_cuda_mesh_without_cuda(group):
    """No quiet CPU step: ``run`` with a ``cuda`` mesh and no CUDA raises
    on every rank."""
    assert not torch.cuda.is_available()
    for r in group["ranks"]:
        assert r["cuda_mesh"].startswith("raised:"), r["cuda_mesh"]


def test_run_mesh_needs_a_process_group():
    """``run(mesh=...)`` without torch.distributed raises: nothing runs
    quietly on one device."""
    with pytest.raises(RuntimeError, match="torch.distributed"):
        run(smoke_config("minitron-4b"), RunConfig(steps=1),
            verbose=False, mesh={"data": 1, "model": 1})


@pytest.mark.parametrize("arch", G.JAX_ARCHS)
def test_mesh_step_equals_jax_sharded_step(group, arch):
    """The JAX package's train-step gradient jitted on a (2, 2) mesh
    (``NamedSharding``s from ``repro.train.sharding``, constraints on)
    against the port's (2, 2) step on the same tree and batch: loss, nll,
    aux and every leaf, for a dense, an SSM, an MLA and a MoE
    architecture."""
    ref = group["jax"][arch]
    n = len([k for k in ref if k[0] == "g" and k[1:].isdigit()])
    want = (float(ref["loss"]), {"nll": float(ref["nll"]),
                                 "aux": float(ref["aux"])},
            [ref[f"g{i}"] for i in range(n)])
    assert_close(group["grads"][arch, "2x2"], want)
    # the reference's gradient leaves came out sharded as the parameters
    assert any("model" in s for s in ref["grad_sharding"])


@pytest.mark.parametrize("mesh", list(G.MESHES))
def test_planned_peak_equals_the_mesh_step(group, mesh):
    """The planner (``count_step`` on fake tensors, shares from the plan)
    against the mesh step itself: every rank's CPU allocations over one
    bf16 train step (the profiler's memory events) within
    ``PLAN_PEAK_RTOL`` of the counted peak, and its parameter shards
    a quarter of the planned static bytes (parameters, gradients, m, v)."""
    d, m = G.MESHES[mesh]
    cfg = ModelConfig(**G.PLAN_CFG)
    shape = ShapeSpec("plan", G.PLAN_S, G.PLAN_B, "train")
    sizes = {"data": d, "model": m}
    plan = D.count_step(cfg, shape, sizes, SH.ShardingRules(),
                        TS.StepConfig(remat=True), device="cpu")
    _, static = D.argument_bytes(cfg, shape, sizes, SH.ShardingRules())
    for r in group["ranks"]:
        peak, local = r["profiled"][mesh]
        assert abs(plan["peak"] - peak) <= PLAN_PEAK_RTOL * peak, \
            (plan["peak"], peak)
        assert 4 * local == static


@pytest.mark.parametrize("rows", [(0, 8), (2, 6), (7, 8)])
def test_batch_rows_equal_the_whole_batch(rows):
    """A rank builds only its rows of a batch: equal to those rows of the
    whole batch (counters over the flat index)."""
    cfg = DataConfig(50280, 8, 65, seed=3)
    whole = host_batch_at(cfg, 11)
    part = host_batch_at(cfg, 11, rows=rows)
    for k in whole:
        np.testing.assert_array_equal(part[k], whole[k][rows[0]:rows[1]])


def test_abstract_params_template_shapes():
    """The restore's templates: one f32 meta tensor per leaf of the
    reference's tree, in its order."""
    cfg = smoke_config(G.CKPT_ARCH)
    got = [tuple(x.shape) for x in tree_leaves(abstract_params(cfg))]
    want = [x.shape for x in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: JT.init_params(j_smoke_config(G.CKPT_ARCH),
                                              jax.random.PRNGKey(0))))]
    assert got == want
