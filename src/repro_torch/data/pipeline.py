"""Deterministic-seekable synthetic LM data (the counterpart of
``repro.data.pipeline``).

``batch_at(cfg, step)`` is a pure function of (seed, step): restarts
replay the exact token stream with no iterator state to checkpoint.  It
draws the same tokens as the JAX package: ``fold_in(PRNGKey(seed),
step)``, then ``jax.random.uniform`` in float64 (the JAX package runs with
x64 on) over ``minval=1e-6``, then the Zipf-ish transform.  The random
bits are JAX's threefry2x32 in its partitionable form (counters are the
flat index split into high and low words; the 64-bit draw is
``hi << 32 | lo``), computed here in numpy, so a job can resume from the
other package's checkpoint and see the same batches.

Two float64 roundings follow XLA's: the uniform's ``floats * (1 - 1e-6) +
1e-6`` is one fused multiply-add (emulated exactly with Dekker's product
and a two-sum), and ``u ** -0.5`` is numpy's ``pow``, which differs from
XLA's in the last bit for a few per cent of draws.  A token can differ only
where that last bit decides the integer part, that is for a value within
one ulp (a relative 2.2e-16) of a token boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.layers import _resolve_device

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0


def _threefry2x32(k1, k2, x0, x1):
    """JAX's threefry2x32 block (20 rounds) on uint32 arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _key(seed: int, step: int):
    """``fold_in(PRNGKey(seed), step)`` as two uint32 words."""
    if not 0 <= step < 1 << 32:
        raise ValueError(f"step {step}: fold_in takes a uint32")
    s = int(seed) % (1 << 64)
    with np.errstate(over="ignore"):
        y0, y1 = _threefry2x32(s >> 32, s & _M32, np.zeros(1, np.uint32),
                               np.full(1, step, np.uint32))
    return y0[0], y1[0]


def _fma(a, b, c):
    """``a * b + c`` rounded once (float64): the product split exactly by
    Veltkamp / Dekker, the sum by a two-sum."""
    p = a * b
    sp = 134217729.0                      # 2^27 + 1
    ah = a * sp - (a * sp - a)
    bh = b * sp - (b * sp - b)
    e = ((ah * bh - p) + ah * (b - bh) + (a - ah) * bh) + (a - ah) * (b - bh)
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _uniform(seed: int, step: int, shape, minval: float = 1e-6, rows=None):
    """``jax.random.uniform(fold_in(PRNGKey(seed), step), shape, float64,
    minval)``, or its rows ``rows = (lo, hi)`` alone (the draws are
    counters over the flat index, so any rows come out as in the whole)."""
    k1, k2 = _key(seed, step)
    row = int(np.prod(shape[1:]))
    lo, hi = rows or (0, shape[0])
    idx = np.arange(lo * row, hi * row, dtype=np.uint64)
    shape = (hi - lo,) + tuple(shape[1:])
    with np.errstate(over="ignore"):
        hi, lo = _threefry2x32(k1, k2, (idx >> np.uint64(32)).astype(np.uint32),
                               (idx & np.uint64(_M32)).astype(np.uint32))
    bits = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    one = np.array(1.0).view(np.uint64)
    floats = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    return np.maximum(minval, _fma(floats, 1.0 - minval, minval)) \
        .reshape(shape)


def host_batch_at(cfg: DataConfig, step: int, rows=None):
    """The batch of ``step`` as numpy int32 arrays ``tokens``, ``labels``
    (batch, seq); with ``rows = (lo, hi)`` only those rows of it (what a
    rank of a mesh holds), equal to the whole batch's."""
    u = _uniform(cfg.seed, int(step), (cfg.batch, cfg.seq + 1), rows=rows)
    # Zipf-ish marginal over the vocab via exponential transform
    z = np.clip((u ** (-0.5) - 1.0) * cfg.vocab / 40.0, 0,
                cfg.vocab - 1).astype(np.int32)
    return {"tokens": z[:, :-1], "labels": z[:, 1:]}


def batch_at(cfg: DataConfig, step: int, device=None, rows=None):
    """The batch of ``step`` (its rows ``rows = (lo, hi)`` alone, if
    named) as int32 tensors on ``device`` (``cuda`` unless named)."""
    dev = _resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host_batch_at(cfg, step, rows).items()}
