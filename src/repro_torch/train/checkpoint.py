"""Checkpointing in the JAX package's format (the counterpart of
``repro.train.checkpoint``).

A checkpoint is one ``arrays.npz`` of flattened leaves plus a JSON
``manifest.json`` (step, leaf counts, extra), written atomically (temp file
+ rename).  Leaves are in ``jax.tree_util`` order: the parameters' dict
keys sorted, depth first (a :class:`ParamTree` keeps that order), then the
optimizer state as ``step``, the leaves of ``m``, the leaves of ``v``.  So
a checkpoint either package writes loads in the other, and a job resumes
across them with the same data stream (``repro_torch.data.pipeline``).

``load_checkpoint`` re-places the leaves on one device, its single-card
form of the reference's elastic re-placement with shardings.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from . import optimizer as O
from . import pytree


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_checkpoint(path, step: int, params, opt_state, extra: dict = None):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves_p = pytree.tree_leaves(params)
    leaves_o = [opt_state.step] + pytree.tree_leaves(opt_state.m) \
        + pytree.tree_leaves(opt_state.v)
    arrs = {f"p{i}": _host(x) for i, x in enumerate(leaves_p)}
    arrs.update({f"o{i}": _host(x) for i, x in enumerate(leaves_o)})
    manifest = {"step": int(step), "n_params": len(leaves_p),
                "n_opt": len(leaves_o), "extra": extra or {}}
    # atomic write: temp + rename (preemption-safe).  NB np.savez appends
    # ".npz" to names lacking it — write the suffixed file and rename that.
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    os.close(fd)
    np.savez(tmp, **arrs)
    os.replace(tmp + ".npz", path / "arrays.npz")
    os.unlink(tmp)
    (path / "manifest.json").write_text(json.dumps(manifest))
    return path


def latest_step(root) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[-1]) for p in root.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _unflatten(template, leaves, dev, what):
    """``leaves`` (numpy, in tree order) as tensors on ``dev`` in the dict
    structure of ``template``; float leaves as f32 (the reference's jitted
    step leaves f64 parameters), each of the template leaf's shape."""
    it = enumerate(leaves)

    def one(t):
        i, a = next(it)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{what} leaf {i}: shape {a.shape}, the "
                             f"template has {tuple(t.shape)}")
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return pytree.tree_map(one, template)


def load_checkpoint(path, params_template, opt_template, device=None):
    """Restore (step, params, opt_state) onto ``device`` (``cuda`` unless
    named).  The templates give the tree structure and shapes only (meta
    tensors will do); ``params`` comes back as a :class:`ParamTree` when
    the template is one, else as a nested dict.  Float leaves are loaded as
    f32: the reference's jitted train step returns f64 parameters under
    its global x64, so its checkpoints from step 1 on hold f64 parameter
    leaves, which this port rounds to f32 (the precision it trains in).
    ``opt_state.step`` stays on the host, as :func:`init_opt_state` keeps
    it."""
    dev = L._resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    n_p, n_o = manifest["n_params"], manifest["n_opt"]
    want_p = len(pytree.tree_leaves(params_template))
    want_o = 1 + 2 * len(pytree.tree_leaves(opt_template.m))
    if (n_p, n_o) != (want_p, want_o):
        raise ValueError(f"{path}: {n_p} parameter and {n_o} optimizer "
                         f"leaves, the templates have {want_p} and {want_o}")
    with np.load(path / "arrays.npz") as z:
        leaves_p = [z[f"p{i}"] for i in range(n_p)]
        leaves_o = [z[f"o{i}"] for i in range(n_o)]
    params = _unflatten(params_template, leaves_p, dev, "params")
    if isinstance(params_template, L.ParamTree):
        params = L.ParamTree(params)
    n_m = (n_o - 1) // 2
    opt = O.OptState(torch.from_numpy(np.asarray(leaves_o[0], np.int32)),
                   _unflatten(opt_template.m, leaves_o[1:1 + n_m], dev, "m"),
                   _unflatten(opt_template.v, leaves_o[1 + n_m:], dev, "v"))
    return manifest["step"], params, opt
