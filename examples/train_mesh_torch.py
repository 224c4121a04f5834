"""LM training over a device mesh, one rank per card — the PyTorch port's
counterpart of the reference's ``launch/train.py`` with shardings:
``launch.train.run(..., mesh=DeviceMesh)`` places the parameters and the
AdamW moments by ``repro_torch.train.sharding`` (FSDP over ``data``,
tensor parallelism over ``model``), each rank builds its own rows of every
batch, and checkpoints restore onto any mesh size.  Checked: the mesh's
losses equal, within the stated tolerance, a one-device run of the same
steps on rank 0; every rank reads the same losses; with ``--resume`` the
run is cut at half way, saved, and resumed on the mesh transposed
(``data`` and ``model`` swapped), and the losses follow on.

    torchrun --standalone --nproc-per-node=4 examples/train_mesh_torch.py \
        [--arch minitron-4b] [--data 2] [--steps 6] [--resume]
    torchrun --standalone --nproc-per-node=4 examples/train_mesh_torch.py \
        --device cpu                                  # gloo on the CPU

The smoke configuration of ``--arch`` (NCCL on ``cuda:LOCAL_RANK``, or
gloo on the CPU); ``--data`` ranks on the data axis, the rest of the
world on ``model``.  The tolerance, ``LOSS_RTOL`` = 5e-3 relative per
step, is the bf16 trajectory's of ``tests/test_torch_train_archs.py``:
the mesh sums in other orders than one device.
"""
import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.train import RunConfig, run  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import StepConfig  # noqa: E402

LOSS_RTOL = 5e-3


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--data", type=int, default=2,
                    help="ranks on the data axis (the rest on model)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--resume", action="store_true",
                    help="checkpoint at half way, resume on the mesh "
                    "transposed")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: NCCL, one card per rank; cpu: gloo")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if args.device == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl")
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo")
    try:
        train(args, device)
    finally:
        dist.destroy_process_group()


def _mesh(device, data, model):
    return DeviceMesh(device.type, torch.arange(data * model).reshape(
        data, model), mesh_dim_names=("data", "model"))


def train(args, device):
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % args.data:
        raise SystemExit(f"--data {args.data} does not divide {world} ranks")
    cfg = smoke_config(args.arch)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=args.steps)
    step_cfg = StepConfig(remat=True)
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = _mesh(device, args.data, world // args.data)
    say(f"ranks={world} mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"arch={cfg.name} device={device}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = [tmp]
        dist.broadcast_object_list(ckpt)     # rank 0's directory for all
        if args.resume:
            half = args.steps // 2
            _, _, first = run(cfg, RunConfig(steps=half, ckpt_every=half,
                                             ckpt_dir=ckpt[0]),
                              opt_cfg, step_cfg, verbose=False, mesh=mesh)
            other = _mesh(device, world // args.data, args.data)
            say(f"resumed at step {half} on mesh "
                f"{dict(zip(other.mesh_dim_names, other.shape))}")
            _, _, rest = run(cfg, RunConfig(steps=args.steps,
                                            ckpt_every=args.steps + 1,
                                            ckpt_dir=ckpt[0]),
                             opt_cfg, step_cfg, verbose=False, mesh=other)
            losses = first + rest
        else:
            _, _, losses = run(cfg, RunConfig(steps=args.steps), opt_cfg,
                               step_cfg, verbose=False, mesh=mesh)
        dist.barrier()
    every = [None] * world
    dist.all_gather_object(every, losses)
    same = all(x == losses for x in every)
    ok = True
    if rank == 0:
        _, _, want = run(cfg, RunConfig(steps=args.steps), opt_cfg,
                         step_cfg, verbose=False, device=device)
        for i, (a, b) in enumerate(zip(losses, want)):
            print(f"step {i}: mesh loss {a:.6f}  one device {b:.6f}")
        ok = len(losses) == len(want) and all(
            abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(losses, want))
    flags = [None] * world
    dist.all_gather_object(flags, ok)
    say(f"mesh == one device: {all(flags)}; every rank's losses equal: "
        f"{same}")
    assert all(flags) and same


if __name__ == "__main__":
    main()
