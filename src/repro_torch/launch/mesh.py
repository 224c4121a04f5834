"""Production meshes (the counterpart of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  Each builds a ``torch.distributed.device_mesh.DeviceMesh``
over the default process group, which the caller initialises: under
``torchrun`` an NCCL group of real ranks, in the dry-run
(``repro_torch.launch.dryrun``) torch's ``fake`` backend at world size 256
or 512, which is the only place such a world exists.  The meshes take the
first ``prod(shape)`` ranks in row-major order (axis strides ``(16, 1)``
for ``(data=16, model=16)``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed.device_mesh as _device_mesh


def _mesh(shape, axes, device_type: str) -> "_device_mesh.DeviceMesh":
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {n}-rank mesh needs torch.distributed initialised first "
            "(torchrun, or the dry-run's fake backend)")
    world = dist.get_world_size()
    if world < n:
        raise ValueError(
            f"need {n} ranks, have {world} — the dry-run must initialise "
            "the fake process group at a world size of at least the mesh")
    return _device_mesh.DeviceMesh(device_type,
                                   torch.arange(n).reshape(shape),
                                   mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(data=16, model=16) single pod; (pod=2, data=16, model=16) two
    pods."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_field_mesh(*, multi_pod: bool = False,
                    device_type: str = "cuda"):
    """z-slab mesh for DDMS field decomposition: 256 or 2x256 blocks.
    The z axis shards over every mesh axis (the block ring)."""
    if multi_pod:
        return _mesh((2, 256), ("pod", "data"), device_type)
    return _mesh((256,), ("data",), device_type)


def batch_axes_for(mesh) -> tuple:
    """The data-parallel axes of ``mesh`` (a ``DeviceMesh`` or a mapping of
    axis name to size), in mesh order."""
    names = mesh.mesh_dim_names \
        if isinstance(mesh, _device_mesh.DeviceMesh) else tuple(mesh)
    return tuple(a for a in names if a in ("pod", "data"))
