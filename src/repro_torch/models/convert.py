"""Carry parameters across between the two packages.

The reference's parameter tree is a nested dict of f32 arrays shaped as
``lm_meta(cfg)`` (layer axes stacked); the port's :class:`ParamTree` holds
the same tree name for name and shape for shape, so the carry-across is a
copy.  Give :func:`params_from_jax` the reference's tree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); :func:`params_to_numpy`
returns that tree again, byte for byte."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig
from .transformer import lm_meta


def _from_numpy(meta, tree, dev, path):
    if isinstance(meta, L.PM):
        a = np.asarray(tree)
        if a.shape != meta.shape or a.dtype != np.float32:
            raise ValueError(f"{path}: {a.dtype}{a.shape}, want "
                             f"float32{meta.shape}")
        return torch.from_numpy(np.array(a, copy=True)).to(dev)
    if not isinstance(tree, dict) or set(tree) != set(meta):
        got = sorted(tree) if isinstance(tree, dict) \
            else type(tree).__name__
        raise ValueError(f"{path}: keys {got}, want {sorted(meta)}")
    return {k: _from_numpy(meta[k], tree[k], dev, f"{path}/{k}")
            for k in meta}


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device=None) -> L.ParamTree:
    """The port's parameters for ``cfg`` from the reference's tree of numpy
    f32 arrays, on ``device`` (``cuda`` unless named).  Raises on a
    missing or extra name, a shape other than ``lm_meta``'s, or a dtype
    other than float32."""
    dev = L._resolve_device(device)
    return L.ParamTree(_from_numpy(lm_meta(cfg), tree, dev, "params"))


def params_to_numpy(params) -> Dict[str, Any]:
    """The nested dict of numpy f32 arrays (host copies) that
    :func:`params_from_jax` takes."""
    tree = params.tree() if isinstance(params, L.ParamTree) else params
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True).numpy()
            for k, v in tree.items()}
