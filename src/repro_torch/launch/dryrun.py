"""Multi-device dry-run planner (the counterpart of ``repro.launch.dryrun``).

For every (architecture x input shape) cell and both production meshes —
(data=16, model=16) and (pod=2, data=16, model=16) — plan the train /
prefill / serve step without allocating anything: the sharding plan
(``repro_torch.train.sharding``) on a ``DeviceMesh`` of a fake world,
per-device memory, the roofline terms on an H100 model
(``repro_torch.launch.roofline``), and persist everything to
``results/dryrun_torch/*.json``.  The DDMS field cells (including the
paper's 6-billion-vertex Fig. 17 example) are planned from the buffers of
``run_front`` (``repro_torch.distributed.shardmap_pipeline``).

The reference lowers and compiles on 512 placeholder XLA devices and reads
``memory_analysis()`` / ``cost_analysis()`` and the optimized HLO.  PyTorch
has none of these, so the port counts:

- **the fake world:** :func:`main` and the ``lower_*`` entry points
  initialise torch's ``fake`` process-group backend at world size 256 or
  512 (nothing is sent anywhere) and destroy it after; this module is the
  only place such a world exists, and it refuses to start one where a
  process group is already up;
- **the cost counter** (:class:`CostCounter`): a ``TorchDispatchMode``
  under ``FakeTensorMode`` over the port's own step functions
  (``make_train_step`` / ``make_prefill_step`` / ``make_serve_step``) on
  fake parameters shaped as ``lm_meta`` and the inputs of
  ``registry.input_specs``.  It counts FLOPs with
  ``torch.utils.flop_counter``'s registry (matrix products and attention
  kernels only: elementwise ops are not FLOPs there, unlike XLA's count),
  bytes as the inputs plus outputs of every non-view aten op, and the live
  bytes of every storage allocated under it (freed when the storage is),
  whose maximum is the step's peak.  The fake tensors are CUDA tensors
  where a card is present, CPU tensors otherwise (a CPU-only build cannot
  run autograd over fake CUDA tensors); the counts do not depend on it,
  and the record names the device (``counted_on``);
- **per device:** the step is counted at the local batch (the global
  batch over the batch devices, where they divide it); FLOPs are the
  global count over the devices; each counted tensor's bytes are divided
  by the devices outside the batch that hold a part of it, from the plan
  (:class:`_Shares`): an activation ``sharding.constrain`` annotated by
  its spec (the counter observes the hook), a parameter, moment or
  gradient leaf by its spec's devices, a bf16 compute copy or a per-layer
  slice by the spec's devices outside the batch axes (the FSDP-gathered
  shard), and any other tensor by the model axis where one of its dims is
  a size the plan shards over it;
- **the optimizer's step counter** stays a real host tensor: its one host
  read (``int(step)``) runs for real, everything else on fake tensors;
- **exact costs** keep the reference's method: count at ``k1`` and ``k2``
  layers with coarse flash tiles and extrapolate linearly to full depth
  (:func:`_exact_costs`); with ``exact=False`` the model's own tiles;
- **memory figures:** argument bytes per device come exactly from the
  plan (parameters, m, v and step, plus the batch shard; the cache for
  decode), output and temp bytes from the counter, in the record's
  ``memory_analysis``; ``static_bytes_per_device`` adds the gradients.

Usage (no card needed; the planner runs no device work):
    python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
        --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
    python -m repro_torch.launch.dryrun --ddms paper_6b --mesh multi
"""

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor as _FakeTensor
from torch._subclasses.fake_tensor import FakeTensorMode as _FakeTensorMode
from torch.utils import _pytree as _tree
from torch.utils._python_dispatch import TorchDispatchMode as _DispatchMode
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.registry import input_specs, shape_applicable
from repro_torch.launch.mesh import (batch_axes_for, make_field_mesh,
                                     make_production_mesh)
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES
from repro_torch.train import sharding as SH
from repro_torch.train import optimizer as O
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (StepConfig, make_prefill_step,
                                          make_serve_step, make_train_step)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# the integer operations per vertex the lower-star pairing needs, as
# measured on the card (402 on `isabel`, 423 on `random` 256^3;
# chip_smoke.py's pairing_work), in place of the reference's TPU guess of
# 5e4 flop-equivalents
DDMS_OPS_PER_VERTEX = 423

_WORLD = {"size": 0}


@contextlib.contextmanager
def _fake_world(n: int):
    """torch's ``fake`` process group at world size ``n`` for the duration
    (nested calls reuse a large enough one); refuses to replace a process
    group it did not start."""
    if _WORLD["size"] >= n:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run's fake world would replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    _WORLD["size"] = n
    try:
        yield
    finally:
        _WORLD["size"] = 0
        dist.destroy_process_group()


def _count_device() -> str:
    """The device of the counter's fake tensors: ``cuda`` where a card is
    present, else ``cpu`` (the counts are the same)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# the cost counter
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# aten ops that read a tensor's metadata, not its data
_METADATA_OPS = {torch.ops.aten.sym_size.int, torch.ops.aten.sym_stride.int,
                 torch.ops.aten.sym_numel.default,
                 torch.ops.aten.sym_storage_offset.default,
                 torch.ops.aten.is_contiguous.default,
                 torch.ops.aten._local_scalar_dense.default}


class CostCounter(_DispatchMode):
    """FLOPs, bytes and peak live bytes of the aten ops run under it
    (enter it inside a ``FakeTensorMode``).  ``share(t)`` is the number
    of devices a tensor's bytes divide over (1: global counts);
    ``share.constrained(shape, spec)`` takes an annotated activation's
    share from its spec (:meth:`constrained`, the observer of
    ``sharding.constrain``).

    - ``flops``: ``torch.utils.flop_counter``'s registry, global;
    - ``bytes``: the inputs plus the outputs of every non-view aten op
      that reads data (not ``prim.device`` or a size query), each tensor
      divided by its share;
    - ``live`` / ``peak``: bytes of the storages allocated under the
      counter (outputs that alias no input), each divided by the share of
      the tensor that allocated it, until the storage is freed;
    - ``lives``: the live bytes after each op, one list per phase, a
      phase being a run of ops inside or outside autograd's backward
      (forward, backward, the optimizer after it): the extrapolation in
      depth takes each phase on its own.

    A host read of a real (not fake) tensor, the optimizer's step counter,
    runs for real."""

    def __init__(self, share=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.share = share or (lambda t: 1)
        self.flops = 0
        self.bytes = 0.0
        self.live = 0.0
        self.peak = 0.0
        self.ops = 0
        self.constraints = 0
        self.lives = []
        self._in_backward = False
        self._alive = {}
        self._shares = {}

    def _free(self, key):
        self.live -= self._alive.pop(key)
        del self._shares[key]

    def know(self, tensors, shares):
        """Give the storages of ``tensors`` (made before the counter:
        parameters, moments, the batch, the cache) their shares."""
        for t, d in zip(tensors, shares):
            self._shares[id(t.untyped_storage())] = d

    def _share(self, t) -> int:
        """A tensor's share is its storage's: decided when the storage was
        allocated (or given by :meth:`know`), so views of it agree."""
        d = self._shares.get(id(t.untyped_storage()))
        return self.share(t) if d is None else d

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default \
                and not isinstance(args[0], _FakeTensor):
            with _disable_current_modes():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.ops += 1
        fl = self._flops_of.get(func._overloadpacket)
        if fl is not None:
            self.flops += fl(*args, **kwargs, out_val=out)
        outs = [t for t in _tree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not func.is_view and func.namespace == "aten" \
                and func not in _METADATA_OPS:
            ins = [t for t in _tree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) / self._share(t)
                              for t in ins + outs)
        for t in () if func.is_view else self._fresh(func, out):
            s = t.untyped_storage()
            key = id(s)
            if key in self._alive:
                continue
            d = self._shares[key] = self.share(t)
            b = s.nbytes() / d
            self._alive[key] = b
            self.live += b
            weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)
        bwd = torch._C._current_graph_task_id() != -1
        if bwd != self._in_backward or not self.lives:
            self._in_backward = bwd
            self.lives.append([])
        self.lives[-1].append(self.live)
        return out

    @staticmethod
    def _fresh(func, out):
        """The outputs of a non-view op that alias none of its inputs (a
        list return's elements share its alias annotation)."""
        rets = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) and len(rets) > 1 \
            else (out,)
        for r, o in zip(rets, outs):
            if r.alias_info is not None:
                continue
            for t in _tree.tree_leaves(o):
                if isinstance(t, torch.Tensor):
                    yield t

    def constrained(self, x, kind, spec):
        """The observer :func:`sharding.constrain` calls: the activation's
        spec gives the share of every tensor of its shape from here on,
        and of its own storage (allocated before it was annotated)."""
        self.constraints += 1
        d = self.share.constrained(tuple(x.shape), spec)
        s = x.untyped_storage()
        key = id(s)
        if key in self._alive and s.nbytes() == _nbytes(x):
            b = s.nbytes() / d
            self.live += b - self._alive[key]
            self._alive[key] = b
            self._shares[key] = d

    def held(self, tree) -> float:
        """Bytes (per device) of the storages of ``tree`` allocated under
        the counter and still alive, each once."""
        keys = {id(t.untyped_storage()) for t in _tree.tree_leaves(tree)
                if isinstance(t, torch.Tensor)}
        return sum(self._alive.get(k, 0.0) for k in keys)


class _Shares:
    """The devices a tensor of one cell's per-device step (the step at
    the local batch) divides over, from the plan.  The step's aten ops
    see reshaped operands, so shapes alone do not name them; in order:

    - a tensor of the shape of an activation ``constrain`` annotated:
      that spec's devices outside the batch axes (the batch is already
      local);
    - a tensor with as many elements as a parameter leaf (whole, or one
      layer of a stacked leaf): in f32 (gradients) its spec's devices; in
      another dtype (the bf16 compute copy) the spec's devices outside
      the batch axes, the FSDP-gathered shard (the parameters, moments,
      inputs and caches themselves get their specs' shares up front,
      :meth:`CostCounter.know`);
    - a tensor one of whose dims, or the product of two adjacent dims, is
      a size the plan shards over the model axis (heads, kv, mlp, vocab,
      experts, lora, ssm heads, or a head-flattened feature), or such a
      size times the local batch (heads flattened with the batch), but
      never ``d_model``, the batch, the sequence length or their product:
      the model axis' size, as tensor parallelism splits it;
    - anything else (the residual stream among it): 1.

    The counter asks once per storage, when it is allocated; views of it
    take its share (:meth:`CostCounter._share`).  A tensor is named by its
    sizes, so where a replicated tensor's size equals one the plan shards
    over the model axis (an ``hd`` equal to a head count times the batch,
    say), or a sharded size equals ``d_model``, the batch or the sequence
    length, its share is wrong; the data axes carry no such guess, as the
    step is counted at the local batch.  ``coinciding`` lists the sharded
    sizes dropped for equalling ``d_model``, the batch or the sequence
    length (the records carry it)."""

    def __init__(self, cfg, shape, specs_meta, mesh, rules):
        sizes = SH.axis_sizes(mesh)
        self.mesh = mesh
        self.bax = bax = tuple(rules.batch_axes)
        self.mdev = sizes[rules.model_axis]
        self.weights = {}
        self.act = {}
        self.model_dims = set()

        def put(key, n):
            self.weights[key] = min(n, self.weights.get(key, n))

        for pm, spec in specs_meta:
            views = [(tuple(pm.shape), tuple(spec))]
            if pm.axes and pm.axes[0] == "layers":
                views.append((tuple(pm.shape[1:]), tuple(spec[1:])))
            for shp, sp in views:
                n = math.prod(shp)
                put((n, True), SH.spec_devices(sp, mesh))
                put((n, False), SH.spec_devices(sp, mesh, skip=bax))
            for i, part in enumerate(spec):
                if rules.model_axis not in SH._axes(part):
                    continue
                for j in range(i + 1, len(pm.shape) + 1):
                    if "embed" in pm.axes[i:j]:
                        break
                    self.model_dims.add(math.prod(pm.shape[i:j]))
        # the batch flattened with heads (the attention's batched products)
        B, S = shape.global_batch, shape.seq_len
        self.model_dims |= {B * m for m in self.model_dims}
        replicated = {1, cfg.d_model, B, S, B * S}
        self.coinciding = sorted(self.model_dims & replicated - {1})
        self.model_dims -= replicated

    def constrained(self, shape, spec) -> int:
        d = SH.spec_devices(spec, self.mesh, skip=self.bax)
        self.act[shape] = d
        return d

    def __call__(self, t) -> int:
        shp = tuple(t.shape)
        hit = self.act.get(shp)
        if hit is not None:
            return hit
        hit = self.weights.get((t.numel(), t.dtype == torch.float32))
        if hit is not None:
            return hit
        dims = set(shp) | {a * b for a, b in zip(shp, shp[1:])}
        return self.mdev if dims & self.model_dims else 1


def _leaves(tree):
    """The leaves of a nested dict, keys sorted (the reference's order)."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in _leaves(tree[k])]


def _fake_tree(tree, dev):
    """Fake tensors (inside a FakeTensorMode) shaped as ``tree``'s meta
    tensors."""
    if isinstance(tree, dict):
        return {k: _fake_tree(v, dev) for k, v in tree.items()}
    return torch.zeros(tuple(tree.shape), dtype=tree.dtype, device=dev)


def count_step(cfg, shape, mesh, rules, step_cfg: StepConfig = StepConfig(),
               device=None):
    """One counted step of ``cfg`` at ``shape`` on fake tensors: {flops
    (global), bytes, peak, lives, output (per device), ops, constraints,
    coinciding, seconds}.  One device's step runs at the local batch (the
    global batch over the batch devices, where they divide it); its
    tensors' bytes divide further as :class:`_Shares` says."""
    dev = device or _count_device()
    sizes = SH.axis_sizes(mesh)
    bdev = math.prod(sizes[a] for a in rules.batch_axes)
    if shape.global_batch % bdev:
        bdev = 1
    gshape = shape
    shape = dataclasses.replace(shape, global_batch=shape.global_batch
                                // bdev)
    meta = T.lm_meta(cfg)
    specs = SH.param_specs(meta, rules, mesh)
    share = _Shares(cfg, shape, list(zip(_leaves(meta), _leaves(specs))),
                    mesh, rules)
    step = torch.zeros((), dtype=torch.int32)        # a real host tensor
    t0 = time.perf_counter()
    try:
        with _FakeTensorMode(allow_non_fake_inputs=True):
            params = _fake_tree(T.abstract_params(cfg), dev)
            ins = {k: _fake_tree(v, dev)
                   for k, v in input_specs(cfg, shape).items()}
            if shape.kind == "train":
                opt = O.OptState(step,
                                 _fake_tree(T.abstract_params(cfg), dev),
                                 _fake_tree(T.abstract_params(cfg), dev))
                fn = make_train_step(cfg, OptConfig(), step_cfg)
                call = (params, opt, ins)
            elif shape.kind == "prefill":
                fn = make_prefill_step(cfg)
                call = (params, ins["tokens"], ins.get("frontend"))
            else:
                cache = _fake_tree(T.init_cache(
                    cfg, shape.global_batch, shape.seq_len, device="meta"),
                    dev)
                fn = make_serve_step(cfg)
                call = (params, cache, ins["token"])
            cc = CostCounter(share)
            bax = tuple(rules.batch_axes)
            pspecs = [SH.spec_devices(sp, mesh) for sp in _leaves(specs)]
            cc.know(_leaves(params), pspecs)
            if shape.kind == "train":
                cc.know(_leaves(opt.m) + _leaves(opt.v), pspecs * 2)
            cc.know(ins.values(), [
                SH.spec_devices(_input_spec(v, rules, sizes), mesh,
                                skip=bax)
                for v in input_specs(cfg, gshape).values()])
            if shape.kind == "decode":
                cmeta = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     device="meta")
                cc.know(_leaves(cache), [
                    SH.spec_devices(sp, mesh, skip=bax) for sp in
                    _leaves(SH.cache_specs(cfg, cmeta, rules, mesh))])
            SH.set_rules(rules, mesh, observe=cc.constrained)
            with cc:
                out = fn(*call)
                output = cc.held(out)
                del out
    finally:
        SH.set_rules(None, None)
    return dict(flops=cc.flops * bdev, bytes=cc.bytes, peak=cc.peak,
                lives=cc.lives, output=output, ops=cc.ops,
                constraints=cc.constraints, coinciding=share.coinciding,
                seconds=time.perf_counter() - t0)


def _variant_layer_counts(cfg):
    if cfg.shared_attn_every:
        k = cfg.shared_attn_every
        return k, 2 * k
    return 2, 4


class _flash_exact:
    """Coarse flash tiles, the reference's (fewer chunk-loop iterations
    to count; eager attention then holds larger score blocks, so bytes
    and temp of cells above S = 2048 read higher than at the model's own
    tiles)."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.saved = (L.FLASH_QC, L.FLASH_KC)
        L.FLASH_QC, L.FLASH_KC = 2048, 4096

    def __exit__(self, *a):
        from repro_torch.models import layers as L
        L.FLASH_QC, L.FLASH_KC = self.saved


def _exact_costs(cfg, shape, mesh, rules, step_cfg, exact: bool = True,
                 device=None):
    """Per-step costs at full depth from two reduced-depth counts (``k1``,
    ``k2`` layers), extrapolated linearly in the layer count: every layer
    runs the same ops, so the step is affine in it (the peak phase by
    phase, :class:`CostCounter`).  ``exact`` counts with
    coarse flash tiles, as the reference compiles its exact variants."""
    k1, k2 = _variant_layer_counts(cfg)
    meas = []
    for k in (k1, k2):
        ckw = dict(n_layers=k)
        if cfg.enc_dec:
            ckw["enc_layers"] = k
        cfgk = dataclasses.replace(cfg, **ckw)
        with (_flash_exact() if exact else contextlib.nullcontext()):
            meas.append(count_step(cfgk, shape, mesh, rules, step_cfg,
                                   device))
    dk = k2 - k1

    def line(a, b):
        per = (b - a) / dk
        return max(0.0, a - k1 * per) + cfg.n_layers * per

    def extrap(key):
        return line(meas[0][key], meas[1][key])

    costs = {k: extrap(k) for k in ("flops", "bytes", "output")}
    # The peak is not affine in depth: which phase holds it changes (the
    # optimizer's at full depth, the backward's at a few layers), and
    # within the optimizer which leaf's temporary (the embedding's at a
    # few layers, a stacked leaf's at full depth).  So each phase is
    # extrapolated on its own: op by op where both depths run the same
    # ops (the optimizer: one pass over the same leaves), else its peak
    # (a phase with a loop over the layers)
    lives = [m.pop("lives") for m in meas]
    if len(lives[0]) != len(lives[1]):
        raise ValueError(f"{cfg.name}: {len(lives[0])} phases at {k1} "
                         f"layers, {len(lives[1])} at {k2}")
    costs["peak"] = max(
        max(map(line, a, b)) if len(a) == len(b) else line(max(a), max(b))
        for a, b in zip(*lives))
    return costs, {"k1": k1, "k2": k2, "measured": meas}


def _input_spec(v, rules, sizes):
    """The spec of one batch input: ``batch_spec``, replicated where the
    batch devices do not divide its batch, the sequence unsharded where
    the model axis does not divide it."""
    spec = SH.batch_spec(rules, v.ndim)
    if v.shape[0] % math.prod(sizes[a] for a in rules.batch_axes):
        return SH.P()
    if rules.seq_shard and v.ndim > 1 \
            and v.shape[1] % sizes[rules.model_axis]:
        return SH.P(spec[0])
    return spec


def _plan_bytes(tree_meta, specs, mesh, nbytes_of):
    """Per-device bytes of a tree of meta tensors / PMs under ``specs``."""
    if isinstance(tree_meta, dict):
        return sum(_plan_bytes(tree_meta[k], specs[k], mesh, nbytes_of)
                   for k in tree_meta)
    return nbytes_of(tree_meta) / SH.spec_devices(specs, mesh)


def argument_bytes(cfg, shape, mesh, rules):
    """(argument, static) bytes per device of one cell from the plan alone:
    the f32 parameters, for training also m, v and the int32 step, plus
    the batch shard (the cache and the token when decoding); static is the
    parameters, with their gradients and moments when training."""
    sizes = SH.axis_sizes(mesh)
    meta = T.lm_meta(cfg)
    specs = SH.param_specs(meta, rules, mesh)
    bsize = math.prod(sizes[a] for a in rules.batch_axes)
    param_pd = _plan_bytes(meta, specs, mesh,
                           lambda pm: math.prod(pm.shape) * 4)
    ins = input_specs(cfg, shape)
    args = param_pd
    if shape.kind == "decode":
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
        args += _plan_bytes(cache, SH.cache_specs(cfg, cache, rules, mesh),
                            mesh, _nbytes)
        tok = ins["token"]
        args += _nbytes(tok) / (bsize if tok.shape[0] % bsize == 0 else 1)
    else:
        for v in ins.values():
            args += _nbytes(v) / SH.spec_devices(
                _input_spec(v, rules, sizes), mesh)
    if shape.kind == "train":
        return args + 2 * param_pd + 4, 4 * param_pd
    return args, param_pd


def plan_cell(cfg, shape, mesh, step_cfg: StepConfig = StepConfig(),
              rules_kw=None, exact: bool = True, device=None):
    """The plan of one LM cell on ``mesh`` (a ``DeviceMesh`` or a mapping
    of axis name to size): the record :func:`lower_cell` writes, less its
    names."""
    n_dev = math.prod(SH.axis_sizes(mesh).values())
    rules = SH.ShardingRules(batch_axes=batch_axes_for(mesh),
                             **(rules_kw or {}))
    t0 = time.perf_counter()
    args, static = argument_bytes(cfg, shape, mesh, rules)
    t_plan = time.perf_counter() - t0

    t0 = time.perf_counter()
    costs, detail = _exact_costs(cfg, shape, mesh, rules, step_cfg, exact,
                                 device)
    t_count = time.perf_counter() - t0
    remat = step_cfg.remat if shape.kind == "train" else False
    coll = RL.collective_bytes(RL.lm_collectives(cfg, shape, mesh, rules,
                                                 remat=remat), mesh)
    mf = RL.model_flops(cfg, shape, n_dev)
    roof = RL.analyze({"flops": costs["flops"] / n_dev,
                       "bytes": costs["bytes"], "collectives": coll}, mf)
    print("roofline:", roof.summary(), flush=True)
    param_bytes = sum(math.prod(pm.shape) * 4
                      for pm in _leaves(T.lm_meta(cfg)))
    mem = {"argument_size_in_bytes": int(args),
           "output_size_in_bytes": int(costs["output"]),
           "temp_size_in_bytes": int(costs["peak"] - costs["output"])}
    return {
        "n_devices": n_dev,
        "lower_s": t_plan, "compile_s": t_count,
        "flops_per_device": roof.flops,
        "bytes_per_device": roof.bytes_accessed,
        "collectives": roof.coll,
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "collective_s": roof.collective_s, "dominant": roof.dominant,
        "model_flops_per_device": mf, "useful_ratio": roof.useful_ratio,
        "scan_level_costs": None,
        "exact_detail": detail,
        # model-sharded sizes the counter could not tell from replicated
        # ones (see _Shares): tensors of these sizes count as replicated
        "coinciding_sizes": detail["measured"][-1]["coinciding"],
        "memory_analysis": mem,
        "param_bytes_global": param_bytes,
        "param_bytes_per_device_fsdp": param_bytes // n_dev,
        "static_bytes_per_device": int(static),
        "peak_bytes_per_device": int(args + costs["peak"]),
        "hardware": "H100 SXM data sheet (roofline.py)",
        "counted_on": device or _count_device(),
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               step_cfg: StepConfig = StepConfig(), rules_kw=None,
               exact: bool = True, mla_absorbed: bool = False):
    from repro_torch.models import layers as L
    saved = L.MLA_ABSORBED_DECODE
    if mla_absorbed:
        L.MLA_ABSORBED_DECODE = True
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    names = {"arch": arch, "shape": shape_name,
             "mesh": "multi" if multi_pod else "single"}
    if not shape_applicable(cfg, shape):
        return dict(names, skipped="long_500k needs sub-quadratic attention "
                                   "(see DESIGN.md §Arch-applicability)")
    try:
        with _fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            return dict(names, **plan_cell(cfg, shape, mesh, step_cfg,
                                           rules_kw, exact))
    finally:
        L.MLA_ABSORBED_DECODE = saved


DDMS_FIELDS = {
    # paper Fig. 17: Turbulent Channel Flow subset, ~6e9 vertices
    "paper_6b": (2048, 1920, 1536),
    # strong-scaling dataset size (paper Sec. VI-A)
    "strong_512": (512, 512, 512),
}


def ddms_block_bytes(fc, rotations=None):
    """Per-block bytes of ``run_front`` for the FrontConfig ``fc``:
    {argument, output, temp} (what a block holds at its peak: argument +
    output + temp), the peak of each phase that can hold it
    (``phases``), and the bytes its passes move {halo_gradient,
    successors, resolution_v, resolution_t}.  ``rotations`` ({"v": r,
    "t": r}) overrides ``ring_rotation_count``.  Per block, with ``n`` =
    nv_local, ``P`` the plane, ``cap`` the crit capacity and ``C = nb x
    percap`` the sample sort's slots, ``percap = ceil(sort_slack x n /
    nb)`` (``order.py``):

    - argument: the f32 slab;
    - output: the int64 ranks, status / partner (74 int8 rows each),
      vstat (int8), vpart (int32), the D0 and dual triplet buffers at
      ``cap`` (13 int64 words and 2 flags a slot) and the replicated
      counts (overflow, four critical counts, unresolved, the critical
      peak);
    - phases["order"], the sample sort (``nb > 1``) at its last step, the
      scatter of the received ranks: the slab and its global ids, the
      sort's n-sized arrays (key, sorted key, bucket, its flags, offsets,
      slots; the rank table of n + 1), the first exchange's padded send
      buffer (16 B a slot and a dump slot per bucket), and both
      exchanges' C-sized arrays (the two received buffers, 16 B a slot;
      the second payload, 16 B; the received and sorted keys, their ranks,
      ids, owners, positions, slots, indices and values, 8 B each; three
      flags): 61 n + 131 C + 16 nb;
    - phases["resolution"], the tet table's ring resolution inside a ring
      rotation's substitution (``nb > 1``): beside the slab, ids, ranks,
      the int64 halo volume and the 153 B of rows a vertex, the three
      coordinates, the vertex partner's offsets, the tet table, the
      critical edge and triangle masks (14 + 36 flags a vertex) and the
      resolved vertex table, the tet table doubled, the rotation's
      current table, and the substitution's seven tables of 6 int64 a
      vertex (offsets, two clamped indices, a gather, two selects and its
      result) and two masks: 715 n; the halo planes and the rotating
      boundary tables: 112 P; the emission's 222 B a triplet slot and
      five query arrays of 16 B: 302 cap.  The rank-free keys have no
      sort phase (their keys are 8 B a vertex), and below the resolution
      the phases hold less (the tet table's build 551 n, the emission
      an own subset of the resolution's);
    - temp: the larger phase less argument and output;
    - halo_gradient: ``roofline.io_bytes`` of the fused kernel's halo
      entry over the block (int32 ranks below 2^31 global vertices, else
      int64) and its two ghost planes;
    - successors: the 24 tet rows of status and partner read (48 B a
      vertex) and the int64 tet table written;
    - resolution_v / resolution_t: per ring rotation the table (nv_local
      x ent int64, ent 1 and 6) and its 2 x crit_capacity queries read and
      written once, times the rotation count.

    The CUDA kernel allocates only its rows (and an int32 copy of the
    halo volume); sorts and ``nonzero`` on the card may hold scratch the
    model leaves out (chip_smoke.py's [plan] holds the sum to the card)."""
    n, P, cap, nb = fc.nv_local, fc.plane, fc.crit_capacity, fc.n_blocks
    nv = n * nb
    rank_bytes = 4 if fc.use_sample_sort and nv < 2 ** 31 else 8
    argument = n * 4
    output = (n * (8 + 74 + 74 + 1 + 4) + cap * (13 * 8 + 2)
              + 1 + 4 * 8 + 8 + 8)
    phases = {"resolution": 715 * n + 112 * P + 302 * cap}
    if fc.use_sample_sort and nb > 1:
        C = int(math.ceil(fc.sort_slack * n / nb)) * nb
        phases["order"] = 61 * n + 131 * C + 16 * nb
    peak = max(argument + output, *phases.values())
    n_t = (n + P) * 6
    rot = {name: (rotations or {}).get(name, fc.ring_rotation_count(ent))
           for name, ent in (("v", 1), ("t", 6))}
    by = dict(halo_gradient=RL.io_bytes(n, rank_bytes, False,
                                        ghosts=2 * P),
              successors=n * 48 + n_t * 8)
    for name, ent in (("v", 1), ("t", 6)):
        by[f"resolution_{name}"] = rot[name] * (2 * n * ent * 8
                                                + 2 * 2 * cap * 8)
    return dict(argument=argument, output=output,
                temp=peak - argument - output, phases=phases,
                rank_bytes=rank_bytes, rotations=rot, passes=by)


def plan_ddms(dims, mesh, crit_cap=4096, ring_rotations=2,
              gradient_chunk=262144, use_sample_sort: bool = True,
              rotations=None, sort_slack: float = 2.0):
    """The plan of ``run_front`` over ``dims`` in one block per device of
    ``mesh`` (a ``DeviceMesh`` or a mapping of axis name to size): the
    record :func:`lower_ddms` writes, less its names."""
    from repro_torch.distributed.shardmap_pipeline import FrontConfig
    t0 = time.perf_counter()
    n_dev = math.prod(SH.axis_sizes(mesh).values())
    fc = FrontConfig(tuple(dims), n_dev, crit_cap=crit_cap,
                     ring_rotations=ring_rotations,
                     gradient_chunk=gradient_chunk,
                     use_sample_sort=use_sample_sort, sort_slack=sort_slack)
    blk = ddms_block_bytes(fc, rotations)
    coll = RL.collective_bytes(RL.ddms_collectives(fc, mesh), mesh)
    mf = float(DDMS_OPS_PER_VERTEX * fc.nv_local)
    roof = RL.analyze({"flops": mf, "bytes": sum(blk["passes"].values()),
                       "collectives": coll}, mf,
                      peak_flops=RL.INT_OPS_PER_S)
    print("roofline:", roof.summary(), flush=True)
    return {
        "n_devices": n_dev,
        "lower_s": time.perf_counter() - t0, "compile_s": 0.0,
        "flops_per_device": roof.flops,
        "bytes_per_device": roof.bytes_accessed,
        "collectives": roof.coll,
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "collective_s": roof.collective_s, "dominant": roof.dominant,
        "model_flops_per_device": mf, "useful_ratio": roof.useful_ratio,
        "memory_analysis": {"argument_size_in_bytes": blk["argument"],
                            "output_size_in_bytes": blk["output"],
                            "temp_size_in_bytes": blk["temp"]},
        "bytes_detail": blk["passes"],
        "phase_bytes": blk["phases"],
        "config": {"crit_cap": crit_cap, "ring_rotations": ring_rotations,
                   "gradient_chunk": gradient_chunk,
                   "use_sample_sort": use_sample_sort,
                   "sort_slack": sort_slack,
                   "crit_capacity": fc.crit_capacity,
                   "rotations": blk["rotations"],
                   "kernel_rank_bytes": blk["rank_bytes"]},
        "hardware": "H100 SXM data sheet (roofline.py)",
    }


def lower_ddms(field: str, multi_pod: bool, crit_cap: int = 4096,
               ring_rotations: int = 2, gradient_chunk=262144,
               use_sample_sort: bool = True):
    dims = DDMS_FIELDS[field]
    with _fake_world(512 if multi_pod else 256):
        mesh = make_field_mesh(multi_pod=multi_pod)
        rec = plan_ddms(dims, mesh, crit_cap, ring_rotations,
                        gradient_chunk, use_sample_sort)
    return dict({"arch": f"ddms:{field}",
                 "shape": f"{dims[0]}x{dims[1]}x{dims[2]}",
                 "mesh": "multi" if multi_pod else "single"}, **rec)


def run_cell(arch, shape_name, mesh_kind, out_dir: Path, skip_existing=True,
             tag="", **kw):
    out = out_dir / f"{arch.replace(':','_')}__{shape_name}__{mesh_kind}" \
        f"{('__' + tag) if tag else ''}.json"
    if skip_existing and out.exists():
        print("exists:", out.name)
        return
    print(f"=== {arch} x {shape_name} x {mesh_kind} ===", flush=True)
    try:
        if arch.startswith("ddms:"):
            rec = lower_ddms(arch.split(":", 1)[1],
                             multi_pod=(mesh_kind == "multi"), **kw)
        else:
            rec = lower_cell(arch, shape_name,
                             multi_pod=(mesh_kind == "multi"), **kw)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print("FAILED:", rec["error"], flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1, default=str))
    print("wrote", out.name, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--ddms", default=None, choices=list(DDMS_FIELDS))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not (args.all or args.ddms or (args.arch and args.shape)):
        ap.error("give --all, --ddms FIELD, or --arch and --shape")

    with _fake_world(512 if "multi" in meshes else 256):
        if args.all:
            for mk in meshes:
                for arch in ARCHS:
                    for shape in SHAPES:
                        run_cell(arch, shape, mk, out_dir,
                                 skip_existing=args.skip_existing)
                for fld in DDMS_FIELDS:
                    run_cell(f"ddms:{fld}", "field", mk, out_dir,
                             skip_existing=args.skip_existing)
            return
        if args.ddms:
            for mk in meshes:
                run_cell(f"ddms:{args.ddms}", "field", mk, out_dir,
                         skip_existing=args.skip_existing)
            return
        for mk in meshes:
            run_cell(args.arch, args.shape, mk, out_dir,
                     skip_existing=args.skip_existing)


if __name__ == "__main__":
    main()
