"""Training loop with checkpoint/restart fault tolerance (the
counterpart of ``repro.launch.train``).

Restartable by construction: the data pipeline is a pure function of step,
checkpoints are atomic, and ``run()`` resumes from the latest checkpoint in
``ckpt_dir`` — killing the process at any point loses at most
``ckpt_every`` steps.  Checkpoints are the JAX package's format, so a run
resumes from the other package's checkpoint on the same token stream.
Without a mesh everything runs on one device, ``cuda`` unless named.  On a
mesh (``run(..., mesh=DeviceMesh)``, one rank per card under
``torchrun``), parameters and moments are placed by
``repro_torch.train.sharding`` (FSDP over the batch axes, tensor
parallelism over ``model``), each rank builds its own rows of every
batch, and a checkpoint restores onto any mesh size (elastic rescale).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch import mesh as _mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as O
from repro_torch.train import sharding as SH
from repro_torch.train.checkpoint import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import StepConfig, make_train_step


@dataclass
class RunConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    seed: int = 0
    log_every: int = 10


def _frontend_at(cfg: ModelConfig, data_cfg: DataConfig, step: int, dev):
    """Seeded stub embeddings for the batch of ``step`` (a pure function of
    the data seed and the step), or None: encoder frames for an enc-dec
    model, patch embeddings for a ``vision_stub`` one.  The synthetic
    token stream carries none, and the reference's ``run`` stops on such
    models for want of them."""
    n = cfg.enc_len if cfg.enc_dec else \
        cfg.n_patches if cfg.frontend == "vision_stub" else 0
    if not n:
        return None
    rng = np.random.default_rng((data_cfg.seed, step))
    fe = rng.standard_normal((data_cfg.batch, n, cfg.d_model), np.float32)
    return torch.from_numpy(fe).to(dev)


def mesh_rules(mesh) -> SH.ShardingRules:
    """The sharding rules of a training mesh: its ``pod`` / ``data`` dims
    are the batch axes (FSDP), ``model`` the tensor-parallel one."""
    return SH.ShardingRules(batch_axes=_mesh.batch_axes_for(mesh))


def mesh_batch(cfg: ModelConfig, data_cfg: DataConfig, step: int, mesh,
               rules: SH.ShardingRules):
    """The batch of ``step`` on ``mesh``: each rank builds only the rows
    it holds (the pipeline is a pure function of the step) and places
    them by ``batch_spec``; the frontend embeddings likewise."""
    dev = SH.mesh_device(mesh)
    n = data_cfg.batch
    rows = SH.batch_rows(n, rules, mesh)
    batch = {k: SH.place_rows(v, n, rules, mesh) for k, v in
             batch_at(data_cfg, step, device=dev, rows=rows).items()}
    fe = _frontend_at(cfg, data_cfg, step, dev)
    batch["frontend"] = None if fe is None else \
        SH.place_rows(fe[rows[0]:rows[1]], n, rules, mesh)
    return batch


def _check_mesh(mesh, device):
    """The mesh's device for this rank; raises where the mesh cannot run
    here (no process group, no CUDA for a ``cuda`` mesh, another
    ``device`` named)."""
    if not dist.is_initialized():
        raise RuntimeError("run(mesh=...) needs torch.distributed "
                           "initialised (torchrun, one rank per card)")
    if mesh.device_type == "cuda":
        L._resolve_device("cuda")
    dev = SH.mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's {dev}")
    return dev


def run(cfg: ModelConfig, run_cfg: RunConfig,
        opt_cfg: OptConfig = OptConfig(),
        step_cfg: StepConfig = StepConfig(remat=False),
        data_cfg: Optional[DataConfig] = None, verbose: bool = True,
        device=None, mesh=None):
    """Train ``run_cfg.steps`` steps from seeded parameters, or from the
    latest checkpoint in ``ckpt_dir``: (params, opt_state, losses of the
    steps run).  Each step reads its loss to the host, as the reference's
    loop does.  With ``mesh`` (a ``DeviceMesh`` with ``data`` and
    ``model`` dims, ``pod`` too on two pods) every rank calls it: the
    parameters (the seeded values of one device, made leaf by leaf) and
    the moments are placed by ``param_shardings``, each step's batch by
    ``batch_spec``, the rules installed around the steps, and a resume
    re-places the checkpoint; every rank returns the same losses."""
    rules = shardings = None
    if mesh is not None:
        dev = _check_mesh(mesh, device)
        rules = mesh_rules(mesh)
        shardings = SH.param_shardings(T.lm_meta(cfg), rules, mesh)
    else:
        dev = L._resolve_device(device)
    data_cfg = data_cfg or DataConfig(cfg.vocab, batch=8, seq=64,
                                      seed=run_cfg.seed)
    start = 0
    last = latest_step(run_cfg.ckpt_dir) if run_cfg.ckpt_dir else None
    if last is not None:
        shapes = T.abstract_params(cfg)
        kw = dict(shardings=shardings, mesh=mesh) if mesh is not None \
            else dict(device=dev)
        start, params, opt = load_checkpoint(
            Path(run_cfg.ckpt_dir) / f"step_{last}", shapes,
            O.OptState(None, shapes, shapes), **kw)
        params = L.ParamTree(params)
        if verbose:
            print(f"resumed from step {start}")
    else:
        if mesh is not None:
            params = L.ParamTree(SH.init_placed(
                T.lm_meta(cfg), run_cfg.seed, rules, mesh, dev))
        else:
            params = T.init_params(cfg, run_cfg.seed, device=dev)
        opt = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, step_cfg)
    losses = []
    if mesh is not None:
        SH.set_rules(rules, mesh)
    try:
        for step in range(start, run_cfg.steps):
            if mesh is not None:
                batch = mesh_batch(cfg, data_cfg, step, mesh, rules)
            else:
                batch = batch_at(data_cfg, step, device=dev)
                batch["frontend"] = _frontend_at(cfg, data_cfg, step, dev)
            params, opt, metrics = step_fn(params, opt, batch)
            if verbose and (step % run_cfg.log_every == 0
                            or step == run_cfg.steps - 1):
                print(f"step {step}: loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f}")
            losses.append(float(metrics["loss"]))
            if run_cfg.ckpt_dir and (step + 1) % run_cfg.ckpt_every == 0:
                save_checkpoint(Path(run_cfg.ckpt_dir) / f"step_{step + 1}",
                                step + 1, params, opt)
    finally:
        if mesh is not None:
            SH.set_rules(None, None)
    return params, opt, losses
