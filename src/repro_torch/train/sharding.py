"""Logical-axis -> mesh-axis sharding rules (the counterpart of
``repro.train.sharding``).

Parallelism scheme on the production mesh (pod?, data=16, model=16):

- TP   : heads / kv / mlp / experts / vocab / lora / ssm_heads -> "model"
- FSDP : the `embed` axis of weight matrices -> "data" (parameters and
         optimizer state are fully sharded; all-gathered per layer)
- DP   : batch -> ("pod", "data") — gradients all-reduce over both
- EP   : MoE experts -> "model" (dbrx: 16/16; moonshot: 64/16 = 4 per device)
- SP   : long-sequence activations may shard "seq" -> "model" (opt-in)

Every rule is divisibility-checked against the actual dim; non-divisible
dims fall back to replication (never uneven padding) so the memory and
roofline numbers stay interpretable — e.g. kv=8 heads on model=16
replicate, and the *per-head feature* axis shards instead (decode caches).

A spec is a :class:`P`, a tuple with one entry per tensor dim: a mesh-axis
name, a tuple of names, or ``None`` (replicated), trailing ``None``s
trimmed where the reference trims them, so ``tuple(spec)`` reads as the
reference's ``PartitionSpec`` does.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or a mapping of axis name to
size (the planner and the tests use the mapping; nothing is allocated).
:func:`param_shardings` gives ``torch.distributed.tensor`` placements per
mesh dimension in place of ``NamedSharding``.

On a ``DeviceMesh`` the counterpart of ``jax.device_put(x,
NamedSharding)`` is :func:`place` (a whole tensor, equal on every rank,
kept only as this rank's part), over a tree :func:`place_tree`; seeded
parameters are made leaf by leaf and placed at once
(:func:`init_placed`), so no rank ever holds the whole tree; a batch is
built by each rank for its own rows only (:func:`batch_rows`,
:func:`place_rows`).  The placed values are the one-device values: a
sharding is a layout.
"""

from __future__ import annotations

import math
import typing
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed.device_mesh as _device_mesh
import torch.distributed.tensor as _dtensor

from repro_torch.models.layers import PM

if typing.TYPE_CHECKING:
    from typing import Mapping, Union
    Mesh = Union[_device_mesh.DeviceMesh, Mapping[str, int]]


def _part(p):
    if isinstance(p, (tuple, list)):
        p = tuple(p)
        return None if not p else (p[0] if len(p) == 1 else p)
    return p


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over ``data``;
    ``tuple(spec)`` gives its entries, spelled as ``jax.sharding.
    PartitionSpec`` spells them (a one-axis tuple as the bare name, an
    empty one as ``None``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_part(p) for p in parts))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class ShardingRules:
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    model_axis: str = "model"
    fsdp: bool = True
    seq_shard: bool = False                   # SP for prefill activations
    rules: Dict[str, object] = field(default_factory=dict)

    def logical_map(self) -> Dict[str, object]:
        m = {
            "vocab": self.model_axis,
            "heads": self.model_axis,
            "kv": self.model_axis,
            "head": None,
            "mlp": self.model_axis,
            "experts": self.model_axis,
            "lora": self.model_axis,
            "ssm_heads": self.model_axis,
            "embed": self.batch_axes if self.fsdp else None,
            "embed2": None,
            "conv": None,
            "state": None,
            "layers": None,
        }
        m.update(self.rules)
        return m


def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, _device_mesh.DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _axes(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_devices(spec, mesh: Mesh, skip=()) -> int:
    """The number of devices ``spec`` splits a tensor over (the product of
    the sizes of the mesh axes it names, ``skip`` left out)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for part in spec for a in _axes(part)
                     if a not in skip)


def _axis_ok(mesh: Mesh, axes, dim: int) -> bool:
    if axes is None:
        return True
    sizes = axis_sizes(mesh)
    n = math.prod(sizes[a] for a in _axes(axes))
    return dim % n == 0


def spec_for_param(pm: PM, rules: ShardingRules, mesh: Mesh,
                   used: Optional[set] = None) -> P:
    """PartitionSpec for one param; each mesh axis used at most once."""
    lm = rules.logical_map()
    taken: set = set()
    out = []
    for dim, ax in zip(pm.shape, pm.axes):
        m = lm.get(ax) if ax is not None else None
        names = _axes(m) if m else ()
        if m is None or any(n in taken for n in names) \
                or not _axis_ok(mesh, m, dim):
            out.append(None)
        else:
            # a singleton axis tuple is spelled as the bare name
            out.append(names[0] if len(names) == 1 else tuple(names))
            taken.update(names)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _map_meta(fn, meta):
    if isinstance(meta, PM):
        return fn(meta)
    return {k: _map_meta(fn, v) for k, v in meta.items()}


def param_specs(meta, rules: ShardingRules, mesh: Mesh):
    return _map_meta(lambda pm: spec_for_param(pm, rules, mesh), meta)


def placements(spec, mesh: Mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec``, one per mesh
    dimension in mesh order: ``Shard(i)`` where the spec puts that axis on
    tensor dim ``i``, else ``Replicate()``."""
    out = []
    for a in axis_sizes(mesh):
        dims = [i for i, part in enumerate(spec) if a in _axes(part)]
        out.append(_dtensor.Shard(dims[0]) if dims
                   else _dtensor.Replicate())
    return tuple(out)


def param_shardings(meta, rules: ShardingRules, mesh: Mesh):
    return _map_meta(
        lambda pm: placements(spec_for_param(pm, rules, mesh), mesh), meta)


def _local_part(x, placements, mesh):
    """The part of the whole tensor ``x`` that this rank holds under
    ``placements`` on ``mesh`` (``Shard`` splits as ``torch.chunk``, mesh
    dimensions in order, as ``DTensor`` nests them)."""
    coord = mesh.get_coordinate()
    for k, pl in enumerate(placements):
        if isinstance(pl, _dtensor.Shard):
            x = x.chunk(mesh.size(k), dim=pl.dim)[coord[k]]
    return x


def mesh_device(mesh):
    """This rank's device of ``mesh``: its current card for a ``cuda``
    mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(x, placements, mesh, device=None):
    """``x``, the whole tensor (equal on every rank), as a ``DTensor`` on
    ``mesh`` with ``placements``: the counterpart of ``jax.device_put(x,
    NamedSharding(mesh, spec))``.  The rank keeps a contiguous copy of its
    part, on ``device`` (``x``'s unless named); nothing is sent.  Every
    split must be even, as the specs' divisibility check makes it."""
    for k, pl in enumerate(placements):
        if isinstance(pl, _dtensor.Shard) \
                and x.shape[pl.dim] % mesh.size(k):
            raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does not "
                             f"split evenly over mesh dim {k}")
    local = _local_part(x, placements, mesh)
    local = local.contiguous().clone() if device is None else local.to(
        device, copy=True, memory_format=torch.contiguous_format)
    return _dtensor.DTensor.from_local(
        local, mesh, placements, run_check=False, shape=x.shape,
        stride=_contiguous_stride(x.shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def place_tree(tree, shardings, mesh):
    """:func:`place` over the leaves of a tree of whole tensors, with the
    placements tree ``shardings`` (:func:`param_shardings`' form)."""
    if isinstance(tree, dict):
        return {k: place_tree(tree[k], shardings[k], mesh)
                for k in sorted(tree)}
    return place(tree, shardings, mesh)


def init_placed(meta, seed: int, rules: ShardingRules, mesh, device):
    """Seeded f32 parameters for every ``PM`` of ``meta``, placed on
    ``mesh`` by :func:`param_shardings`: each leaf is drawn whole from one
    generator seeded with ``seed`` on ``device``, in the order of
    ``init_tree``, and kept only as this rank's part before the next is
    drawn; so the values are ``init_tree``'s (``init_params(cfg, seed)``'s
    on that device) and a rank holds at most one whole leaf at a time."""
    from repro_torch.models.layers import init_param
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def walk(m):
        if isinstance(m, PM):
            whole = init_param(gen, m)
            x = place(whole, placements(spec_for_param(m, rules, mesh),
                                        mesh), mesh)
            del whole
            return x
        return {k: walk(m[k]) for k in sorted(m)}

    return walk(meta)


def _batch_coord(rules: ShardingRules, mesh):
    """(index, count): this rank's position along the batch axes of
    ``mesh`` (row-major over them, as ``DTensor`` nests ``Shard(0)``) and
    their number of devices."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for a in names:
        if a in rules.batch_axes:
            idx = idx * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
    return idx, n


def batch_rows(n: int, rules: ShardingRules, mesh):
    """(lo, hi): the rows of a global batch of ``n`` that this rank holds
    under :func:`batch_spec` (all ``n`` where the batch devices do not
    divide it: the batch is then replicated, as the planner's
    ``_input_spec`` has it)."""
    idx, count = _batch_coord(rules, mesh)
    if n % count:
        return 0, n
    per = n // count
    return idx * per, (idx + 1) * per


def place_rows(local, n: int, rules: ShardingRules, mesh):
    """A batch input as a ``DTensor``: ``local`` holds this rank's rows
    :func:`batch_rows` of a global batch of ``n`` (the rank built only
    those); batch over the batch axes, every other dim replicated."""
    _, count = _batch_coord(rules, mesh)
    spec = batch_spec(rules, 1) if n % count == 0 else P()
    shape = (n,) + tuple(local.shape[1:])
    return _dtensor.DTensor.from_local(
        local.contiguous(), mesh, placements(spec, mesh), run_check=False,
        shape=shape, stride=_contiguous_stride(shape))


def batch_spec(rules: ShardingRules, ndim: int, seq_axis: int = 1) -> P:
    """Tokens/labels: batch over DP axes (+ optional SP on the seq axis)."""
    parts = [tuple(rules.batch_axes)] + [None] * (ndim - 1)
    if rules.seq_shard and ndim > seq_axis:
        parts[seq_axis] = rules.model_axis
    return P(*parts)


def cache_specs(cfg, cache_tree, rules: ShardingRules, mesh: Mesh):
    """Decode-cache shardings: batch over DP if divisible; the trailing
    feature axis over model if divisible (kv-head counts rarely divide the
    model axis, the flattened/per-head feature usually does).
    ``cache_tree`` is a nested dict of tensors (``meta`` ones will do)."""
    sizes = axis_sizes(mesh)
    model = rules.model_axis
    msize = sizes[model]
    bsize = math.prod(sizes[a] for a in rules.batch_axes)

    def spec(x):
        if x.ndim == 0:
            return P()
        parts = [None] * x.ndim
        if x.shape[0] % bsize == 0:
            parts[0] = tuple(rules.batch_axes)
        for i in range(x.ndim - 1, 0, -1):
            if x.shape[i] % msize == 0 and x.shape[i] >= msize:
                parts[i] = model
                break
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else spec(t)

    return walk(cache_tree)


# ---------------------------------------------------------------------------
# activation sharding-constraint hooks (set by launchers and the planner)
# ---------------------------------------------------------------------------

_CURRENT: Optional[Tuple[ShardingRules, Mesh,
                         Optional[typing.Callable]]] = None


def set_rules(rules: Optional[ShardingRules], mesh: Optional[Mesh],
              observe: Optional[typing.Callable] = None):
    """Install rules+mesh so model code can constrain activations.  Call with
    (None, None) to disable (CPU unit tests run without constraints).
    ``observe(x, kind, spec)``, when given, sees every activation
    :func:`constrain` annotates (the planner's counter takes the
    activations' shares from it)."""
    global _CURRENT
    _CURRENT = (rules, mesh, observe) if rules is not None else None


def gather_batch_axes(x):
    """The ``DTensor`` ``x`` replicated over the batch axes (of the
    installed rules, else the mesh's ``pod`` and ``data`` dims), its other
    placements kept: how a parameter's compute copy is used (FSDP
    gathers the ``embed`` shards per layer; tensor parallelism keeps the
    model-axis ones)."""
    mesh = x.device_mesh
    bax = _CURRENT[0].batch_axes if _CURRENT is not None \
        else ("pod", "data")
    want = [_dtensor.Replicate() if name in bax else pl
            for name, pl in zip(mesh.mesh_dim_names, x.placements)]
    if want == list(x.placements):
        return x
    return x.redistribute(mesh, want)


def constrain(x, kind: str):
    """Annotate an activation: kind in {'tokens','logits','decode'}.
    No-op unless rules are installed.  With rules, the activation's spec is
    passed to the installed observer, and a ``DTensor`` on a
    ``DeviceMesh`` is redistributed to it; a plain tensor is returned as
    it is.  Values never change."""
    if _CURRENT is None:
        return x
    rules, mesh, observe = _CURRENT
    sizes = axis_sizes(mesh)
    bsize = math.prod(sizes[a] for a in rules.batch_axes)
    parts = [None] * x.ndim
    if x.shape[0] % bsize == 0:
        parts[0] = tuple(rules.batch_axes)
    if kind == "logits" and x.shape[-1] % sizes[rules.model_axis] == 0:
        parts[-1] = rules.model_axis
    if kind == "tokens" and rules.seq_shard and x.ndim >= 3 \
            and x.shape[1] % sizes[rules.model_axis] == 0:
        parts[1] = rules.model_axis
    spec = P(*parts)
    if observe is not None:
        observe(x, kind, spec)
    if isinstance(x, _dtensor.DTensor) \
            and isinstance(mesh, _device_mesh.DeviceMesh):
        return x.redistribute(mesh, placements(spec, mesh))
    return x
