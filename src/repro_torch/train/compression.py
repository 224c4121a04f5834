"""Gradient compression (opt-in): int8 quantization with error feedback
(the counterpart of ``repro.train.compression``).

For the data-parallel gradient all-reduce, int8 + a per-tensor scale cuts
the bytes 4x against f32.  Error feedback (the residual carried across
steps) keeps SGD-style convergence.  ``compress`` / ``decompress`` equal
the reference's bit for bit (``torch.round`` rounds half to even, as
``jnp.round`` does; the scale divides as a 0-d tensor, never as a host
scalar, which CUDA would turn into a reciprocal multiply).  The all-reduce
runs over a ``torch.distributed`` process group in place of a
``shard_map`` axis.
"""

from __future__ import annotations

import torch

from . import pytree

def compress(g, residual):
    """Quantize g+residual to int8 (per-tensor scale), return
    (q_int8, scale, new_residual)."""
    def one(g, r):
        x = g.float() + r
        scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) \
            / torch.full((), 127.0, device=x.device)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale, x - q.float() * scale

    out = [one(gl, rl) for gl, rl in zip(pytree.tree_leaves(g),
                                         pytree.tree_leaves(residual))]
    return tuple(pytree.tree_unflatten(g, [o[i] for o in out])
                 for i in range(3))


def decompress(q, scale):
    return pytree.tree_map(lambda qq, ss: qq.float() * ss, q, scale)


def init_residual(params):
    return pytree.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)


def allreduce_compressed(g, residual, group=None):
    """Data-parallel gradient all-reduce with int8 error-feedback
    compression over the process group ``group`` (the default group if
    None): every rank's dequantized payload ``q * s`` summed in f32, then
    divided by the world size.  Returns (mean gradient, new residual)."""
    import torch.distributed as dist
    q, scale, new_res = compress(g, residual)
    n = dist.get_world_size(group)

    def reduce_one(qq, ss):
        x = qq.float() * ss
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x / torch.full((), n, dtype=torch.float32, device=x.device)

    return pytree.tree_map(reduce_one, q, scale), new_res
