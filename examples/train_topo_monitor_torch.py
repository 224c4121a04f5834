"""End-to-end example on the PyTorch port: train an LM while monitoring the
topology of its loss landscape with in-situ persistence diagrams (the
counterpart of ``examples/train_topo_monitor.py``, same flags and printed
lines, plus ``--device``).

The monitor's ``TopoService`` runs the pipeline's default back-end on the
device, so on a GPU each landscape's 2-D grid goes through the fused
lower-star CUDA kernel.  The random plane is drawn from a seeded
``torch.Generator`` (the reference draws it with ``jax.random``).

    PYTHONPATH=src python examples/train_topo_monitor_torch.py --steps 200
    PYTHONPATH=src python examples/train_topo_monitor_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.cache import DiagramCache  # noqa: E402
from repro_torch.core.grid import Grid  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import TopoService  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa
from repro_torch.train.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.train_step import (StepConfig, loss_fn,  # noqa: E402
                                          make_train_step)


def loss_landscape_values(cfg, params, batch, step_cfg, n=12, radius=0.05,
                          seed=0):
    """The loss on an n x n grid of the 2-D random plane through
    ``params`` (directions of norm ``radius`` per entry, a, b in [-1, 1]),
    as an (n, n) float32 array."""
    dev = tree_leaves(params)[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def direction(p):
        return torch.randn(p.shape, generator=gen, dtype=p.dtype,
                           device=dev) * radius
    with torch.no_grad():
        d1 = tree_map(direction, params)
        d2 = tree_map(direction, params)
        vals = np.zeros((n, n), np.float32)
        for i, a in enumerate(np.linspace(-1, 1, n)):
            for j, b in enumerate(np.linspace(-1, 1, n)):
                p = tree_map(lambda w, x, y: w + float(a) * x + float(b) * y,
                             params, d1, d2)
                vals[i, j] = float(loss_fn(cfg, step_cfg, p, batch["tokens"],
                                           batch["labels"])[0])
    return vals


def landscape_d0(svc, vals):
    """D0 pairs of persistence > 0 of the landscape, from ``svc``."""
    n = vals.shape[0]
    res = svc.diagram(vals.reshape(-1), grid=Grid.of(n, n))
    d0 = res.pairs(0, min_persistence=0)
    return d0[d0[:, 0] != d0[:, 1]]


def loss_landscape_pd(cfg, params, batch, step_cfg, svc, n=12, radius=0.05,
                      seed=0):
    """2-D random-plane loss-landscape slice -> persistence diagram D0.

    The diagram is answered by the shared cache-enabled ``TopoService``:
    a repeated check of an unchanged landscape (same sampled values) is
    a cache hit — the monitor then costs one decode, not a recompute."""
    vals = loss_landscape_values(cfg, params, batch, step_cfg, n, radius,
                                 seed)
    return vals, landscape_d0(svc, vals)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--model-dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--monitor-every", type=int, default=30)
    ap.add_argument("--landscape-n", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and the diagrams run")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="topo-lm", family="dense", n_layers=args.layers,
                      d_model=args.model_dim, n_heads=4, n_kv=2,
                      d_ff=4 * args.model_dim, vocab=2048)
    nparams = cfg.param_count()
    print(f"model: {nparams/1e6:.1f}M params")
    dc = DataConfig(cfg.vocab, batch=8, seq=64)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step_cfg = StepConfig(remat=False)
    params = T.init_params(cfg, 0, device=args.device)
    opt = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, step_cfg)

    # one cache-enabled service answers every topology check: distinct
    # landscapes compute + store, a repeated check is a decode-only hit
    with TopoService(cache=DiagramCache(max_bytes=32 << 20), max_wait_s=0.0,
                     device=args.device) as svc:
        vals = d0 = None
        for step in range(args.steps):
            batch = batch_at(dc, step, device=args.device)
            params, opt, m = step_fn(params, opt, batch)
            if step % 10 == 0:
                print(f"step {step}: loss {float(m['loss']):.4f}")
            if (step + 1) % args.monitor_every == 0:
                vals, d0 = loss_landscape_pd(cfg, params, batch, step_cfg,
                                             svc, n=args.landscape_n)
                pers = (d0[:, 1] - d0[:, 0]) if len(d0) else np.zeros(1)
                print(f"  [topo] loss-landscape slice: {len(d0)} D0 pairs, "
                      f"max persistence {pers.max():.4f} "
                      f"(roughness of the local landscape)")
        if vals is not None:
            # re-check the final landscape: same sampled values, same
            # cache key — answered from the stored payload
            p2 = landscape_d0(svc, vals)
            if not np.array_equal(p2, d0):
                raise AssertionError("the cached landscape diagram differs")
            s = svc.stats.as_dict()
            print(f"  [topo] re-check of the final landscape: cache "
                  f"{s['cache_hits']} hit(s) / {s['cache_misses']} "
                  f"miss(es) — repeated monitors are decode-only")
            if s["cache_hits"] < 1:
                raise AssertionError("the re-check missed the cache")
    print("done")


if __name__ == "__main__":
    main()
