"""The PyTorch port's LM training over a device mesh on the CPU: four gloo
processes, one ``DeviceMesh("cpu")`` per shape of ``MESHES`` over the
same group, for ``tests/test_torch_train_mesh.py``.

    python tests/torch_train_mesh_group.py run INPUTS.pt OUT.pt
    python tests/torch_train_mesh_group.py ref OUT.npz

``run`` reads the inputs the test wrote (the parameter trees as numpy,
the batch, a checkpoint directory) and writes what every rank got: the
CPU allocations' peak of one profiled train step of ``PLAN_CFG`` at each
mesh; for each architecture of ``ARCHS`` and mesh, the f32-compute loss,
metrics and gradient leaves (gathered) of ``loss_and_grads`` on
``DTensor`` parameters placed by ``param_shardings``; ``microbatches=2``
at (2, 2); a 3-step bf16 ``run(mesh=...)`` at (2, 2); a checkpoint saved
by ``run`` at (2, 2) after 2 steps and resumed at (4, 1) for one more
(f32 compute); and whether ``run`` refuses a ``cuda`` mesh without CUDA.

``ref`` runs the JAX package's train-step gradient of each architecture
of ``JAX_ARCHS`` jitted on a (data=2, model=2) mesh of 4 forced host
devices, parameters and batch placed with ``NamedSharding``s from
``repro.train.sharding`` and its activation constraints installed, in
f32 compute, on the parameter trees the test gives both sides: the JAX
package's own for ``REF_ARCH``, the port's seeded one for the others.
"""

import os
import sys
import tempfile

WORLD = 4
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
ARCHS = ("h2o-danube-3-4b", "mamba2-2.7b", "minicpm3-4b",
         "moonshot-v1-16b-a3b")
REF_ARCH = "minitron-4b"
# held against the JAX package's sharded step: the dense REF_ARCH and the
# SSM, MLA and MoE families of ARCHS
JAX_ARCHS = (REF_ARCH, "mamba2-2.7b", "minicpm3-4b", "moonshot-v1-16b-a3b")
B, S = 4, 16                 # the gradient checks' batch (data=4 divides)
TRAJ_ARCH, TRAJ_STEPS = "minitron-4b", 3
CKPT_ARCH = "h2o-danube-3-4b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# the planner's check: a small dense model (H * hd == d_model, as
# minitron-4b's, so the counter's coinciding size is there too), one bf16
# train step with remat, profiled for its CPU allocations
PLAN_CFG = dict(name="plan-mini", family="dense", n_layers=2, d_model=256,
                n_heads=8, n_kv=4, d_ff=768, vocab=8192)
PLAN_B, PLAN_S = 2, 512
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def _grads(cfg, tree, batch, mesh, step_cfg):
    """(per-rank loss, metrics, gathered gradient leaves) of the port's
    ``loss_and_grads`` on ``mesh``."""
    import torch
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.transformer import lm_meta
    from repro_torch.train import sharding as SH
    from repro_torch.train import train_step as TS
    from repro_torch.train.pytree import tree_leaves
    rules = SH.ShardingRules()
    whole = params_from_jax(cfg, tree, device="cpu").tree()
    params = SH.place_tree(
        whole, SH.param_shardings(lm_meta(cfg), rules, mesh), mesh)
    lo, hi = SH.batch_rows(B, rules, mesh)
    placed = {k: SH.place_rows(torch.from_numpy(v[lo:hi]), B, rules, mesh)
              for k, v in batch.items()}
    SH.set_rules(rules, mesh)
    try:
        loss, m, g = TS.loss_and_grads(cfg, step_cfg, params, placed)
    finally:
        SH.set_rules(None, None)
    leaves = [x.full_tensor().numpy() for x in tree_leaves(g)]
    return float(loss), {k: float(v) for k, v in m.items()}, leaves


def _profiled_step(mesh):
    """(peak bytes allocated on this rank's CPU during one train step of
    ``PLAN_CFG`` on ``mesh``, from the profiler's memory events; bytes of
    the local shards of the parameters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import mesh_batch, mesh_rules
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import ParamTree
    from repro_torch.train import sharding as SH
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.pytree import tree_leaves
    cfg = ModelConfig(**PLAN_CFG)
    rules = mesh_rules(mesh)
    params = ParamTree(SH.init_placed(T.lm_meta(cfg), 0, rules, mesh, "cpu"))
    opt = init_opt_state(params)
    batch = mesh_batch(cfg, DataConfig(cfg.vocab, PLAN_B, PLAN_S), 0, mesh,
                       rules)
    step = TS.make_train_step(cfg, OptConfig(**OPT),
                              TS.StepConfig(remat=True))
    SH.set_rules(rules, mesh)
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            step(params, opt, batch)
    finally:
        SH.set_rules(None, None)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    local = sum(x.to_local().numel() * 4 for x in tree_leaves(params))
    return peak, local


def _worker(rank, init, inputs, out_dir):
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import RunConfig, run
    from repro_torch.models import layers as L
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig
    data = torch.load(inputs, weights_only=False)
    meshes = {k: DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                            mesh_dim_names=("data", "model"))
              for k, shape in MESHES.items()}
    out = {"grads": {}, "losses": {}}
    out["profiled"] = {name: _profiled_step(m) for name, m in meshes.items()}
    plain = TS.StepConfig(remat=False)
    bf16 = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        for arch in ARCHS + (REF_ARCH,):
            cfg = smoke_config(arch)
            names = MESHES if arch in ARCHS else ("2x2",)
            for name in names:
                loss, m, g = _grads(cfg, data["trees"][arch],
                                    data["batches"][arch], meshes[name],
                                    plain)
                out["losses"][arch, name] = loss
                if rank == 0:
                    out["grads"][arch, name] = (loss, m, g)
        cfg = smoke_config(TRAJ_ARCH)
        mb = _grads(cfg, data["trees"][TRAJ_ARCH], data["batches"][TRAJ_ARCH],
                    meshes["2x2"], TS.StepConfig(microbatches=2,
                                                 remat=False))
        out["losses"]["microbatches"] = mb[0]
        if rank == 0:
            out["microbatches"] = mb
        # elastic restore: saved at (2, 2) after 2 steps, resumed at (4, 1)
        cfg = smoke_config(CKPT_ARCH)
        ckpt = data["ckpt_dir"]
        _, _, first = run(cfg, RunConfig(steps=2, ckpt_every=2,
                                         ckpt_dir=ckpt),
                          OptConfig(**OPT), plain, verbose=False,
                          mesh=meshes["2x2"])
        _, _, resumed = run(cfg, RunConfig(steps=3, ckpt_every=100,
                                           ckpt_dir=ckpt),
                            OptConfig(**OPT), plain, verbose=False,
                            mesh=meshes["4x1"])
        out["restore"] = {"first": first, "resumed": resumed}
    finally:
        L.COMPUTE_DTYPE = bf16
    cfg = smoke_config(TRAJ_ARCH)
    _, opt, traj = run(cfg, RunConfig(steps=TRAJ_STEPS, ckpt_every=100),
                       OptConfig(**OPT), plain, verbose=False,
                       mesh=meshes["2x2"])
    out["trajectory"] = traj
    out["traj_step"] = int(opt.step)
    # a cuda mesh without CUDA: run refuses it before any work
    cuda = DeviceMesh("cuda", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    try:
        run(cfg, RunConfig(steps=1), verbose=False, mesh=cuda)
        out["cuda_mesh"] = "ran"
    except RuntimeError as e:
        out["cuda_mesh"] = f"raised: {e}"
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_group(inputs, out):
    """Spawn the four ranks; ``out`` gets rank 0's results with every
    rank's losses under ``"ranks"``."""
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, nprocs=WORLD, join=True, args=(
            "file://" + os.path.join(tmp, "rendezvous"), inputs, tmp))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
    res = ranks[0]
    res["ranks"] = [{k: r[k] for k in ("losses", "restore", "trajectory",
                                       "cuda_mesh", "profiled")}
                    for r in ranks]
    torch.save(res, out)
    print("WROTE", out)


def param_tree(arch):
    """The parameter tree (numpy, the JAX package's layout) both sides load
    for ``arch``: the JAX package's own for ``REF_ARCH``, the port's seeded
    one for the others (a JAX initialisation per architecture would cost
    the test file a third of its time)."""
    if arch == REF_ARCH:
        import torch_lm_ref as R
        return R.tree(arch)
    from repro_torch.configs import smoke_config
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.models.transformer import init_params
    return params_to_numpy(init_params(smoke_config(arch), 0, device="cpu"))


def reference(out):
    """The JAX package's f32 loss and gradient of each of ``JAX_ARCHS``
    jitted on a (2, 2) mesh of forced host devices; the arrays are saved
    as ``ARCH.NAME``."""
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={WORLD} "
        + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, SRC)
    sys.path.insert(0, HERE)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import smoke_config
    from repro.data.pipeline import DataConfig, host_batch_at
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro.train import sharding as JSH
    from repro.train import train_step as JTS
    assert jax.device_count() == WORLD, jax.device_count()
    mesh = Mesh(np.array(jax.devices()).reshape(MESHES["2x2"]),
                ("data", "model"))
    rules = JSH.ShardingRules()
    bs = NamedSharding(mesh, JSH.batch_spec(rules, 2))
    JL.COMPUTE_DTYPE = jnp.float32
    JSH.set_rules(rules, mesh)
    sc = JTS.StepConfig(remat=False)
    arrays = {}
    for arch in JAX_ARCHS:
        cfg = smoke_config(arch)
        sp = JSH.param_shardings(JT.lm_meta(cfg), rules, mesh)
        batch = host_batch_at(DataConfig(cfg.vocab, B, S), 0)

        def loss(p, b, cfg=cfg):
            return JTS.loss_fn(cfg, sc, p, b["tokens"], b["labels"])

        fn = jax.jit(jax.value_and_grad(loss, has_aux=True),
                     in_shardings=(sp, {"tokens": bs, "labels": bs}))
        params = jax.device_put(param_tree(arch), sp)
        (lval, m), g = fn(params, {k: jax.device_put(v, bs)
                                   for k, v in batch.items()})
        leaves = jax.tree_util.tree_leaves(g)
        arrays.update({f"{arch}.loss": np.asarray(lval),
                       f"{arch}.nll": np.asarray(m["nll"]),
                       f"{arch}.aux": np.asarray(m["aux"]),
                       f"{arch}.grad_sharding": np.array(
                           [str(x.sharding.spec) for x in leaves])})
        arrays.update({f"{arch}.g{i}": np.asarray(x)
                       for i, x in enumerate(leaves)})
    np.savez(out, **arrays)
    print("WROTE", out)


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run_group(sys.argv[2], sys.argv[3])
    else:
        reference(sys.argv[2])
