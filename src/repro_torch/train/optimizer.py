"""AdamW + LR schedule in PyTorch (the counterpart of
``repro.train.optimizer``).

Parameters, gradients and moments are nested dicts of f32 tensors shaped as
the parameter tree (a :class:`~repro_torch.models.layers.ParamTree` is
taken as its ``tree()``).  :func:`adamw_update` writes the parameters and
the moments in place, leaf by leaf, and uses the gradient leaf as scratch,
with one more leaf-sized temporary at a time: at full width the largest
leaf is several GB, and three copies of the tree (parameters, ``m``,
``v``) already fill most of the card.

The arithmetic is the reference's eager ``adamw_update`` op for op in f32,
so on the CPU the parameters and moments equal it bit for bit whenever the
gradient norms agree (the sum of squares is reduced in another order, so
the norm can differ in its last bits, and with it the clipping scale).
The reference's *jitted* step computes the bias-corrected update in
float64 (``b1 ** step`` is a strong f64 under jit and x64) and returns f64
parameters; this port keeps them f32.

The step counter lives on the host (``OptState.step`` is a 0-d int32 CPU
tensor), so the learning rate and the bias corrections are host scalars
and an update reads nothing back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.tensor as _dtensor

from . import pytree


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init_opt_state(params) -> OptState:
    """Zero f32 moments on the parameters' devices (placed as the
    parameters on a mesh), step 0 (host)."""
    def zeros(p):
        if isinstance(p, _dtensor.DTensor):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32),
                    pytree.tree_map(zeros, params),
                    pytree.tree_map(zeros, params))


def lr_at(cfg: OptConfig, step):
    """The reference's schedule value at ``step`` as a 0-d f32 CPU tensor:
    linear warmup (computed in f64, rounded to f32, as the reference's
    weak-typed warmup branch), then cosine decay in f32.  The cosine itself
    is taken in f64 and rounded, the correctly rounded f32 value; XLA's f32
    ``cos`` may differ from it in the last bit."""
    step = int(step)
    if step < cfg.warmup_steps:
        return torch.tensor(cfg.lr * (step + 1) / cfg.warmup_steps,
                            dtype=torch.float32)
    f32 = np.float32
    t = f32(step - cfg.warmup_steps) \
        / f32(max(1, cfg.total_steps - cfg.warmup_steps))
    t = min(max(t, f32(0.0)), f32(1.0))
    cos = f32(np.cos(np.float64(f32(np.pi) * t)))
    return torch.tensor(f32(0.5 * cfg.lr) * (f32(1.0) + cos),
                        dtype=torch.float32)


def _local(x):
    """The part of ``x`` this rank holds (``x`` itself off a mesh)."""
    return x.to_local() if isinstance(x, _dtensor.DTensor) else x


def _mesh_sum(vec, mesh):
    """``vec`` summed over the ranks of ``mesh``, in place: one
    all-reduce where the mesh is the whole process group, else one per
    mesh dimension."""
    if mesh.size() == dist.get_world_size():
        dist.all_reduce(vec)
        return
    for k in range(mesh.ndim):
        if mesh.size(k) > 1:
            dist.all_reduce(vec, group=mesh.get_group(k))


def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.  On a
    mesh each leaf's sum of squares is the sum of its shards' (a rank
    that holds a replica counts only where it is the first along every
    mesh dimension the leaf is replicated over), all leaves' taken in one
    all-reduce of a vector, then summed in leaf order as off a mesh."""
    leaves = pytree.tree_leaves(tree)
    if not any(isinstance(x, _dtensor.DTensor) for x in leaves):
        total = sum(torch.sum(x.float() ** 2) for x in leaves)
        return torch.sqrt(total)
    mesh = next(x for x in leaves
                if isinstance(x, _dtensor.DTensor)).device_mesh
    coord = mesh.get_coordinate()
    sums = []
    for x in leaves:
        s = torch.sum(_local(x).float() ** 2)
        if any(not pl.is_shard() and c for pl, c in zip(x.placements,
                                                        coord)):
            s = torch.zeros_like(s)
        sums.append(s)
    vec = torch.stack(sums)
    _mesh_sum(vec, mesh)
    return torch.sqrt(sum(vec.unbind()))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state: OptState):
    """One AdamW step: ``(params, new state, {"gnorm", "lr"})``.

    ``params`` and ``state.m`` / ``state.v`` are updated in place (the
    returned ``params`` is the object given); ``grads`` is consumed as
    scratch.  Every product and quotient is one f32 rounding in the
    reference's order; divisions by a scalar divide by a 0-d tensor on the
    leaf's device, because CUDA turns a division by a host scalar into a
    multiplication by its reciprocal."""
    b1, b2 = cfg.betas
    gnorm = global_norm(grads)
    dev = gnorm.device
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32, device=dev)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    step = int(state.step) + 1
    lr = lr_at(cfg, state.step)
    # the reference's eager bias corrections: f64, rounded to f32 at use
    c1 = torch.full((), 1 - b1 ** step, dtype=torch.float32, device=dev)
    c2 = torch.full((), 1 - b2 ** step, dtype=torch.float32, device=dev)
    for leaves in zip(*map(pytree.tree_leaves,
                           (params, grads, state.m, state.v))):
        # on a mesh each rank updates its own shards: m and v are placed
        # as the parameters, so no leaf needs a collective
        p, g, m, v = map(_local, leaves)
        g = g.float() if g.dtype != torch.float32 else g
        g.mul_(scale)
        tmp = g * (1 - b2)
        tmp.mul_(g)
        v.mul_(b2).add_(tmp)                       # b2 v + (1-b2) g g
        g.mul_(1 - b1)
        m.mul_(b1).add_(g)                         # b1 m + (1-b1) g
        torch.div(m, c1, out=tmp)                  # mh
        torch.div(v, c2, out=g)                    # vh
        g.sqrt_().add_(cfg.eps)
        tmp.div_(g)                                # mh / (sqrt(vh) + eps)
        torch.mul(p, cfg.weight_decay, out=g)
        tmp.add_(g).mul_(lr)
        p.sub_(tmp)
        del tmp          # freed before the next leaf's temporary
    return params, OptState(torch.tensor(step, dtype=torch.int32),
                            state.m, state.v), \
        {"gnorm": gnorm, "lr": lr}
