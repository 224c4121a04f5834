"""Training loop with checkpoint/restart fault tolerance (the
counterpart of ``repro.launch.train``).

Restartable by construction: the data pipeline is a pure function of step,
checkpoints are atomic, and ``run()`` resumes from the latest checkpoint in
``ckpt_dir`` — killing the process at any point loses at most
``ckpt_every`` steps.  Checkpoints are the JAX package's format, so a run
resumes from the other package's checkpoint on the same token stream.
Everything runs on one device, ``cuda`` unless named.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as O
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


def run(cfg: ModelConfig, run_cfg: RunConfig,
        opt_cfg: OptConfig = OptConfig(),
        step_cfg: StepConfig = StepConfig(remat=False),
        data_cfg: Optional[DataConfig] = None, verbose: bool = True,
        device=None):
    """Train ``run_cfg.steps`` steps from seeded parameters, or from the
    latest checkpoint in ``ckpt_dir``: (params, opt_state, losses of the
    steps run).  Each step reads its loss to the host, as the reference's
    loop does."""
    dev = L._resolve_device(device)
    data_cfg = data_cfg or DataConfig(cfg.vocab, batch=8, seq=64,
                                      seed=run_cfg.seed)
    start = 0
    last = latest_step(run_cfg.ckpt_dir) if run_cfg.ckpt_dir else None
    if last is not None:
        shapes = T.abstract_params(cfg)
        start, params, opt = load_checkpoint(
            Path(run_cfg.ckpt_dir) / f"step_{last}", shapes,
            O.OptState(None, shapes, shapes), device=dev)
        params = L.ParamTree(params)
        if verbose:
            print(f"resumed from step {start}")
    else:
        params = T.init_params(cfg, run_cfg.seed, device=dev)
        opt = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, step_cfg)
    losses = []
    for step in range(start, run_cfg.steps):
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
    return params, opt, losses
