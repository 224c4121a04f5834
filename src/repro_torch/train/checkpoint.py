"""Checkpointing in the JAX package's format (the counterpart of
``repro.train.checkpoint``).

A checkpoint is one ``arrays.npz`` of flattened leaves plus a JSON
``manifest.json`` (step, leaf counts, extra), written atomically (temp file
+ rename).  Leaves are in ``jax.tree_util`` order: the parameters' dict
keys sorted, depth first (a :class:`ParamTree` keeps that order), then the
optimizer state as ``step``, the leaves of ``m``, the leaves of ``v``.  So
a checkpoint either package writes loads in the other, and a job resumes
across them with the same data stream (``repro_torch.data.pipeline``).

``load_checkpoint`` re-places the leaves on one device, or with
``shardings`` on a ``DeviceMesh`` (the reference's elastic re-placement):
a checkpoint written at any world size, by either package, restores at
any other.  On a mesh ``save_checkpoint`` gathers each sharded leaf (every
rank takes part), rank 0 writes, and every rank waits at a barrier.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.tensor as _dtensor

from repro_torch.models import layers as L
from . import optimizer as O
from . import pytree


def _host(x, keep=True) -> Optional[np.ndarray]:
    """``x`` whole on the host; a ``DTensor`` is gathered first (a
    collective: every rank calls this), and with ``keep`` false the
    gathered leaf is dropped at once."""
    if isinstance(x, _dtensor.DTensor):
        x = x.full_tensor()
    if not keep:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_checkpoint(path, step: int, params, opt_state, extra: dict = None):
    """Write ``step``'s parameters and optimizer state to ``path``.  With
    ``DTensor`` leaves (a mesh) every rank must call it: each leaf is
    gathered in turn, rank 0 writes, and all ranks return after it has.
    Only rank 0 keeps the gathered leaves on the host."""
    path = Path(path)
    leaves_p = pytree.tree_leaves(params)
    leaves_o = [opt_state.step] + pytree.tree_leaves(opt_state.m) \
        + pytree.tree_leaves(opt_state.v)
    on_mesh = any(isinstance(x, _dtensor.DTensor) for x in leaves_p + leaves_o)
    keep = not on_mesh or dist.get_rank() == 0
    arrs = {f"p{i}": _host(x, keep) for i, x in enumerate(leaves_p)}
    arrs.update({f"o{i}": _host(x, keep) for i, x in enumerate(leaves_o)})
    if not keep:
        dist.barrier()
        return path
    path.mkdir(parents=True, exist_ok=True)
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
    if on_mesh:
        dist.barrier()
    return path


def latest_step(root) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[-1]) for p in root.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _unflatten(template, z, keys, dev, what, shardings=None, mesh=None):
    """The arrays ``keys`` (in tree order) of the open npz ``z`` as tensors
    on ``dev`` in the dict structure of ``template``; float leaves as f32
    (the reference's jitted step leaves f64 parameters), each of the
    template leaf's shape.  Each leaf is read only when its turn comes.
    With ``shardings`` (a placements tree) each leaf becomes a ``DTensor``
    on ``mesh``, and only this rank's part goes to ``dev``, so one whole
    leaf at most is on the host at a time."""
    from .sharding import place
    it = enumerate(keys)

    def one(t, pl=None):
        i, key = next(it)
        a = z[key]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{what} leaf {i}: shape {a.shape}, the "
                             f"template has {tuple(t.shape)}")
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(dev) if pl is None else place(x, pl, mesh, device=dev)

    if shardings is None:
        return pytree.tree_map(one, template)
    return pytree.tree_map(one, template, shardings)


def load_checkpoint(path, params_template, opt_template, device=None,
                    shardings=None, mesh=None):
    """Restore (step, params, opt_state) onto ``device`` (``cuda`` unless
    named), or with ``shardings`` onto ``mesh``: ``shardings`` is the
    parameters' placements tree (``sharding.param_shardings``), and ``m``
    and ``v`` are placed as the parameters, each rank keeping its part
    (on the mesh's device).  The templates give the tree structure and
    shapes only (meta tensors will do); ``params`` comes back as a
    :class:`ParamTree` when the template is one, else as a nested dict.
    Float leaves are loaded as f32: the reference's jitted train step
    returns f64 parameters under its global x64, so its checkpoints from
    step 1 on hold f64 parameter leaves, which this port rounds to f32
    (the precision it trains in).  ``opt_state.step`` stays on the host,
    as :func:`init_opt_state` keeps it."""
    if (shardings is None) != (mesh is None):
        raise ValueError("shardings and mesh go together")
    if mesh is not None:
        from .sharding import mesh_device
        dev = mesh_device(mesh)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")
    else:
        dev = L._resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    n_p, n_o = manifest["n_params"], manifest["n_opt"]
    want_p = len(pytree.tree_leaves(params_template))
    want_o = 1 + 2 * len(pytree.tree_leaves(opt_template.m))
    if (n_p, n_o) != (want_p, want_o):
        raise ValueError(f"{path}: {n_p} parameter and {n_o} optimizer "
                         f"leaves, the templates have {want_p} and {want_o}")
    kw = dict(shardings=shardings, mesh=mesh)
    n_m = (n_o - 1) // 2
    keys_o = [f"o{i}" for i in range(n_o)]
    with np.load(path / "arrays.npz") as z:
        params = _unflatten(params_template, z,
                            [f"p{i}" for i in range(n_p)], dev, "params",
                            **kw)
        opt = O.OptState(torch.from_numpy(np.asarray(z["o0"], np.int32)),
                         _unflatten(opt_template.m, z, keys_o[1:1 + n_m],
                                    dev, "m", **kw),
                         _unflatten(opt_template.v, z, keys_o[1 + n_m:],
                                    dev, "v", **kw))
    if isinstance(params_template, L.ParamTree):
        params = L.ParamTree(params)
    return manifest["step"], params, opt
