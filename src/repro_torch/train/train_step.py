"""Train / serve step factories in PyTorch (the counterpart of
``repro.train.train_step``).

``make_train_step`` builds the step the launcher uses: cross-entropy (+ MoE
aux loss, + z-loss), optional microbatch gradient accumulation (the
reference's ``lax.scan`` as a loop: gradients summed in f32 and divided by
the count, the loss averaged, the other metrics those of the last
microbatch), per-block rematerialization through ``lm_apply(remat=True)``,
and the in-place AdamW update.  The gradient is autograd's over the same
torch ops as the forward: the reference has no hand-written backward
(``_flash_sdpa``, ``ssd_chunked`` and ``moe`` are differentiated by
``jax.value_and_grad``).

Gradients go into preallocated f32 buffers shaped as the parameter tree.
Each parameter enters the forward as a detached leaf whose ``.grad`` is
its buffer, so autograd adds into it in place; a parameter stacked on a
leading layer axis enters as one such leaf per layer, each a view of one
layer of the parameter and of the buffer.  Indexing the stacked tensor
instead would give every layer's backward a zero-filled gradient of the
whole stack.  The buffers are handed to the optimizer as scratch and
dropped with the step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.distributed.tensor as _dtensor

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from . import pytree
from .optimizer import OptConfig, adamw_update


@dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    remat: bool = True
    aux_weight: float = 0.01
    z_weight: float = 1e-4


def loss_fn(cfg: ModelConfig, step_cfg: StepConfig, params, tokens, labels,
            frontend=None):
    """(loss, {"nll", "aux"}): mean token cross-entropy + ``aux_weight`` x
    the MoE aux loss + ``z_weight`` x the mean squared logsumexp, on the
    parameters' device.  ``vision_stub`` logits are sliced to the text
    positions; ``frontend`` is the patch or frame embeddings."""
    # per-block rematerialization: peak activations = one layer, not the
    # whole stack (whole-model checkpointing would not bound peak memory)
    logits, aux = T.lm_apply(cfg, params, tokens, frontend,
                             remat=step_cfg.remat)
    if cfg.frontend == "vision_stub":
        logits = logits[:, cfg.n_patches:]                # text positions only
    labels = torch.as_tensor(labels, device=logits.device).long()
    if isinstance(logits, _dtensor.DTensor):
        nll, lse = _mesh_nll_lse(logits, labels)
        z = torch.mean(lse ** 2)
    else:
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    mean_nll = torch.mean(nll)
    loss = mean_nll + step_cfg.aux_weight * aux + step_cfg.z_weight * z
    return loss, {"nll": mean_nll, "aux": aux}


class _ShardLogSoftmax(torch.autograd.Function):
    """``log_softmax`` over the last dim of ``x``, this rank's shard of a
    vocab split over the process group ``group``: the max and the sum of
    exponentials are all-reduced, and the output is saved for the
    backward pass, as the one-device op saves it."""

    @staticmethod
    def forward(ctx, x, group):
        m = x.amax(-1, keepdim=True)
        dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
        out = x - m
        se = torch.exp(out).sum(-1, keepdim=True)
        dist.all_reduce(se, group=group)
        out.sub_(torch.log(se))
        ctx.group = group
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        s = g.sum(-1, keepdim=True)
        dist.all_reduce(s, group=ctx.group)
        e = torch.exp(out)
        e.mul_(s)
        return g - e, None


def _token_placements(logits, split, op):
    """Placements of a per-token value (B, S) of ``DTensor`` logits: its
    batch and sequence placements, ``Partial(op)`` on the mesh dim
    ``split`` that splits the vocab."""
    return [_dtensor.Partial(op) if k == split else pl if pl.is_shard() else
            _dtensor.Replicate() for k, pl in enumerate(logits.placements)]


def _mesh_nll_lse(logits, labels):
    """(nll, logsumexp) per token of ``DTensor`` logits (B, S, V) with the
    vocab split as the logits hold it (tensor parallelism splits it over
    the model axis): ``log_softmax`` and ``logsumexp`` run on each rank's
    vocab shard as the one-device ops run on the whole, joined by
    all-reduces over the splitting mesh dim, and the label's log-prob is
    picked from the rank that holds it.  The values are the one-device
    values up to the order of sums; the vocab is never gathered."""
    mesh = logits.device_mesh
    vd = logits.ndim - 1
    split = [k for k, pl in enumerate(logits.placements) if pl.is_shard(vd)]
    if len(split) > 1:
        logits = logits.redistribute(mesh, [
            _dtensor.Replicate() if pl.is_shard(vd) else pl
            for pl in logits.placements])
    logits = L._summed(logits)
    k = split[0] if len(split) == 1 else None
    x = logits.to_local()
    lab_pl = [pl if pl.is_shard() and pl.dim < vd else _dtensor.Replicate()
              for pl in logits.placements]
    lab = L._like(labels, logits).redistribute(mesh, lab_pl).to_local()
    if k is None:
        logp = F.log_softmax(x, dim=-1)
        lse = torch.logsumexp(x, dim=-1)
        pick = torch.gather(logp, -1, lab[..., None])[..., 0]
        return tuple(_dtensor.DTensor.from_local(t, mesh, lab_pl,
                                                 run_check=False)
                     for t in (-pick, lse))
    group = mesh.get_group(k)
    n = x.shape[-1]
    lo = mesh.get_coordinate()[k] * n
    logp = _ShardLogSoftmax.apply(x, group)
    idx = lab - lo
    held = (idx >= 0) & (idx < n)
    pick = torch.gather(logp, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    pick = torch.where(held, pick, 0.0)
    nll = -L._summed(_dtensor.DTensor.from_local(
        pick, mesh, _token_placements(logits, k, "sum"), run_check=False))
    # logsumexp: the shard's own, then joined over the shards
    part = torch.logsumexp(x, dim=-1)
    top = _dtensor.DTensor.from_local(part.detach(), mesh,
                             _token_placements(logits, k, "max"),
                             run_check=False)
    top = L._summed(top).to_local()
    se = L._summed(_dtensor.DTensor.from_local(torch.exp(part - top), mesh,
                                      _token_placements(logits, k, "sum"),
                                      run_check=False))
    lse = torch.log(se) + _dtensor.DTensor.from_local(top, mesh, se.placements,
                                             run_check=False)
    return nll, lse


def _stacked(meta):
    """The meta tree with True at every parameter stacked on a leading
    layer axis."""
    if isinstance(meta, L.PM):
        return bool(meta.axes) and meta.axes[0] == "layers"
    return {k: _stacked(v) for k, v in meta.items()}


def _grad_leaves(params, grads, stacked):
    """The tree the forward differentiates: detached leaves sharing each
    parameter's storage, ``.grad`` preset to the matching view of
    ``grads``; a stacked parameter becomes the list of its layers."""
    if isinstance(params, dict):
        return {k: _grad_leaves(params[k], grads[k], stacked[k])
                for k in params}
    parts = zip(params.detach(), grads) if stacked else \
        ((params.detach(), grads),)
    leaves = []
    for p, g in parts:
        p = p.detach().requires_grad_()
        p.grad = g
        leaves.append(p)
    return leaves if stacked else leaves[0]


def _grad_buffer(p):
    """A zero f32 gradient buffer for ``p``, placed as ``p`` is on a
    mesh."""
    if isinstance(p, _dtensor.DTensor):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _microbatch(v, n: int, i: int):
    """Rows ``i B / n ... (i + 1) B / n`` of the batch input ``v``, as the
    reference's reshape takes them; a ``DTensor`` slice is placed over the
    batch axes again (replicated where they do not divide it)."""
    if not isinstance(v, _dtensor.DTensor):
        return torch.as_tensor(v).chunk(n)[i]
    from .sharding import place
    part = v.full_tensor().chunk(n)[i]
    mesh = v.device_mesh
    even = all(part.shape[pl.dim] % mesh.size(k) == 0
               for k, pl in enumerate(v.placements) if pl.is_shard())
    return place(part, v.placements if even
                 else [_dtensor.Replicate()] * mesh.ndim, mesh)


def _value(x):
    """A metric as a plain 0-d tensor, equal on every rank (a ``DTensor``
    is reduced to its value)."""
    return x.full_tensor() if isinstance(x, _dtensor.DTensor) else x


def loss_and_grads(cfg: ModelConfig, step_cfg: StepConfig, params, batch):
    """(loss, metrics, grads) of ``batch`` (tokens, labels, + frontend)
    at ``params``: the reference's ``value_and_grad`` of :func:`loss_fn`,
    over ``step_cfg.microbatches`` equal slices of the batch when more than
    one (gradients summed in f32 and divided by the count, the loss
    averaged, ``nll`` and ``aux`` those of the last slice).  ``grads`` is a
    nested dict of f32 tensors shaped as the parameters.  On a mesh
    (``DTensor`` parameters and batch, ``sharding.set_rules`` installed)
    the gradients are placed as the parameters, and the loss and metrics
    are plain 0-d tensors, equal on every rank."""
    tree = pytree.as_tree(params)
    grads = pytree.tree_map(_grad_buffer, tree)
    leaves = _grad_leaves(tree, grads, _stacked(T.lm_meta(cfg)))
    n = step_cfg.microbatches
    if any(len(v) % n for v in batch.values()):
        raise ValueError(f"the batch does not split into {n} microbatches")
    lsum = None
    for i in range(n):
        mb = {k: _microbatch(v, n, i) for k, v in batch.items()}
        loss, metrics = loss_fn(cfg, step_cfg, leaves, mb["tokens"],
                                mb["labels"], mb.get("frontend"))
        loss.backward()
        loss = _value(loss.detach())
        lsum = loss if lsum is None else lsum + loss
    del leaves
    metrics = {k: _value(v.detach()) for k, v in metrics.items()}
    if n == 1:
        return lsum, metrics, grads
    count = torch.full((), n, dtype=torch.float32, device=lsum.device)
    for g in pytree.tree_leaves(grads):
        (g.to_local() if isinstance(g, _dtensor.DTensor) else g).div_(count)
    return lsum / count, metrics, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    step_cfg: StepConfig = StepConfig()):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).  ``batch`` is a dict with tokens/labels (+frontend);
    ``params`` (a ParamTree or its dict) and the moments of ``opt_state``
    are updated in place; metrics are 0-d tensors (``lr`` on the host)."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(
            cfg, step_cfg, params,
            {k: v for k, v in batch.items() if v is not None})
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        del grads
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, token):
        with torch.no_grad():
            return T.decode_step(cfg, params, cache, token)
    return serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill(params, tokens, frontend=None):
        with torch.no_grad():
            logits, _ = T.lm_apply(cfg, params, tokens, frontend)
        return logits[:, -1]
    return prefill
