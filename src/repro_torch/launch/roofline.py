"""Roofline terms of a planned step on NVIDIA H100s (the counterpart of
``repro.launch.roofline``).

Hardware model: H100 SXM, from NVIDIA's data sheet (dense rates, no
sparsity, at the full 700 W power limit) — 989 TFLOP/s bf16 per GPU,
3.35 TB/s HBM3, NVLink 4 at 450 GB/s per direction between the 8 GPUs of
one node, and one 400 Gb/s NDR InfiniBand link, 50 GB/s, per GPU between
nodes.  A collective over a set of mesh axes runs on NVLink only where
every group of ranks it spans lies in one 8-GPU node of the mesh's
row-major rank layout (the axes are the trailing mesh axes and their sizes
multiply to a divisor of 8); otherwise its slowest hop is InfiniBand.  On
the production mesh (data=16, model=16), strides (16, 1), both axes cross
nodes: a model group is 16 consecutive ranks, two nodes.  The z-slab ring
of the field mesh (256 blocks) crosses a node every 8 blocks, and a ring
shift waits for its slowest hop, so it is InfiniBand too.

Three terms per cell:

    compute_s    = FLOPs_per_device / PEAK_FLOPS
    memory_s     = bytes_per_device / HBM_BW
    collective_s = sum over collectives of result_bytes / link rate

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses collectives out of the optimized HLO; the port has neither.  Its
FLOPs and bytes are counted from the step's aten ops
(``repro_torch.launch.dryrun``) and its collectives are the ones the
sharding plan implies (:func:`lm_collectives`, :func:`ddms_collectives`),
summed by :func:`collective_bytes`.  MODEL_FLOPS = 6*N*D (dense) or
6*N_active*D (MoE) per trained token, 2*N_active per decoded token; the
ratio MODEL/counted exposes remat and padding waste.

Beside them, the rates ``chip_smoke.py`` bounds kernels with, and the one
byte count of a lower-star pairing launch (:func:`io_bytes`) that the
planner and ``chip_smoke.py`` share.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.train import sharding as SH

PEAK_FLOPS = 989e12          # bf16 dense / GPU
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s per direction, inside a node
IB_BW = 50e9                 # bytes/s per GPU between nodes (400 Gb/s NDR)
GPUS_PER_NODE = 8

# the rates kernels are bounded with: HBM, the 67 TFLOP/s float32 rate
# outside the tensor cores, and integer work at half of it (an H100 SM
# issues int32 on 64 of its 128 lanes)
HBM_BYTES_PER_S = HBM_BW
H100_BF16_FLOPS = PEAK_FLOPS
H100_F32_FLOPS = 67e12
INT_OPS_PER_S = H100_F32_FLOPS / 2

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def io_bytes(n, rank_bytes, prepass, ghosts=0):
    """Bytes a pairing launch must move: each input read once (ranks,
    plus the (n, 27) tensor for the prepass kernel, plus ``ghosts`` ghost
    keys for the halo entry), each output written once (74 + 74 + 1 + 4
    B/vertex)."""
    return (n * rank_bytes * (28 if prepass else 1) + ghosts * rank_bytes
            + n * (74 + 74 + 1 + 4))


def link_bandwidth(mesh, axes) -> float:
    """Bytes/s of a collective over ``axes`` of ``mesh`` (a ``DeviceMesh``
    or a mapping of axis name to size, in rank-major order): NVLink when
    the axes are the trailing mesh axes and their sizes multiply to a
    divisor of GPUS_PER_NODE, else InfiniBand."""
    sizes = SH.axis_sizes(mesh)
    names = list(sizes)
    axes = [a for a in names if a in axes]
    trailing = names[len(names) - len(axes):] == axes
    span = math.prod(sizes[a] for a in axes)
    return NVLINK_BW if trailing and GPUS_PER_NODE % span == 0 else IB_BW


def collective_bytes(entries, mesh) -> Dict[str, float]:
    """Result bytes per device of each collective kind over ``entries``
    (``(kind, result_bytes, axes)`` triples, as :func:`lm_collectives` and
    :func:`ddms_collectives` give them), their ``count``, and ``seconds``:
    each entry's bytes over the link rate of its axes
    (:func:`link_bandwidth`).  An entry over axes of total size 1 moves
    nothing and is dropped."""
    sizes = SH.axis_sizes(mesh)
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    secs = 0.0
    for kind, nbytes, axes in entries:
        if math.prod(sizes[a] for a in axes) <= 1 or nbytes <= 0:
            continue
        out[kind] += int(nbytes)
        out["count"] += 1
        secs += nbytes / link_bandwidth(mesh, axes)
    out["seconds"] = secs
    return out


def lm_collectives(cfg, shape, mesh, rules, *, remat: bool = True):
    """The collectives one step of ``cfg`` at ``shape`` implies on ``mesh``
    under ``rules`` (``repro_torch.train.sharding``), per device, as
    ``(kind, result_bytes, axes)``.  ``D`` = data-parallel devices (the
    batch axes), ``t`` = tokens per device
    (B*S/D, B/D when decoding, B*S when B does not divide over D; whisper's
    encoder leaves use its frame count, the VLM adds its patches), ``p`` =
    passes over a layer (train: forward + backward, + 1 recompute with
    remat; prefill / decode: 1).  Per parameter leaf with spec ``s``:

    - FSDP all-gather (``s`` uses a batch axis): p x bf16 bytes / devices
      of ``s`` outside the batch axes (the gathered shard), over the
      batch axes;
    - its gradient's reduce-scatter (train): f32 bytes / devices of
      ``s``, over the batch axes;
    - DP all-reduce of a leaf ``s`` keeps whole over the batch axes
      (train): f32 bytes / devices of ``s``;
    - TP all-reduce, where the leaf's last axis is ``embed`` and another
      of its axes (not ``experts``) is on the model axis (a row-parallel
      product: ``wo``, ``wd``, ``out_proj``): p x layers x t x d x 2 B
      over the model axis — the forward and recompute sum its output, the
      backward the input gradient of the column-parallel product before
      it;
    - the embedding's vocab-sharded lookup: one all-reduce of t x d x 2 B;
      vocab-sharded logits: 2 x p x t x 4 B (the max and the sum of the
      log-softmax), over the model axis;
    - experts on the model axis: 2 all-to-alls (dispatch, combine) per
      MoE layer and pass of capacity_factor x t x top_k x d x 2 B.

    Collectives over axes of size 1 move nothing (:func:`collective_bytes`
    drops them)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import PM
    sizes = SH.axis_sizes(mesh)
    bax = tuple(rules.batch_axes)
    max_ = (rules.model_axis,)
    D = math.prod(sizes[a] for a in bax)
    train = shape.kind == "train"
    passes = (2 + int(remat)) if train else 1
    B = shape.global_batch
    seq = 1 if shape.kind == "decode" else shape.seq_len
    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        seq += cfg.n_patches
    enc_seq = shape.seq_len if train else cfg.enc_len

    def tokens(s):
        return B * s // D if B % D == 0 else B * s

    t_dec = tokens(seq)
    d = cfg.d_model
    vocab_leaf = ("embed",) if cfg.tie_embeddings else ("unembed",)
    out = []

    def walk(meta, path):
        if isinstance(meta, PM):
            yield path, meta
            return
        for k in sorted(meta):
            yield from walk(meta[k], path + (k,))

    meta = T.lm_meta(cfg)
    for path, pm in walk(meta, ()):
        spec = SH.spec_for_param(pm, rules, mesh)
        n = math.prod(pm.shape)
        dev_all = SH.spec_devices(spec, mesh)
        dev_model = SH.spec_devices(spec, mesh, skip=bax)
        fsdp = any(a in bax for part in spec for a in SH._axes(part))
        if fsdp:
            out.append(("all-gather", passes * n * 2 / dev_model, bax))
            if train:
                out.append(("reduce-scatter", n * 4 / dev_all, bax))
        elif train:
            out.append(("all-reduce", n * 4 / dev_all, bax))
        on_model = [ax for i, ax in enumerate(pm.axes) if i < len(spec)
                    and rules.model_axis in SH._axes(spec[i])]
        layers = pm.shape[0] if pm.axes[0] == "layers" else 1
        if path[0] == "shared_attn":
            layers = -(-cfg.n_layers // cfg.shared_attn_every)
        t = tokens(enc_seq) if path[0] == "enc" else t_dec
        if pm.axes[-1] == "embed" and any(
                a not in ("experts", "vocab") for a in on_model):
            out.append(("all-reduce", passes * layers * t * d * 2, max_))
        if path == ("embed",) and "vocab" in on_model:
            out.append(("all-reduce", t_dec * d * 2, max_))
        if path == vocab_leaf and "vocab" in on_model:
            out.append(("all-reduce", 2 * passes * t_dec * 4, max_))
        if cfg.moe is not None and path[-2:] == ("ffn", "wg") \
                and "experts" in on_model:
            mo = cfg.moe
            a2a = mo.capacity_factor * t_dec * mo.top_k * d * 2
            out.extend([("all-to-all", a2a, max_)] * (2 * passes * layers))
    return out


def ddms_collectives(front_cfg, mesh, rank_bytes: int = 8):
    """The collectives of one ``run_front`` block (``repro_torch.
    distributed.shardmap_pipeline``) over every axis of the field mesh,
    per device, as ``(kind, result_bytes, axes)``.  ``P`` = plane (nx x
    ny), ``nb`` blocks, ``cap`` = the sample sort's padded capacity
    (ceil(slack x nv_local / nb) x nb), ``r_v`` / ``r_t`` the vertex and
    tet rotations (``ring_rotation_count``):

    - sample sort: all-gather of nb - 1 int64 splitter samples and of the
      per-block counts (nb x (nb - 1) x 8 and nb x 8 B); two all-to-alls
      of (key, flag) / (gid, rank) int64 pairs, cap x 16 B each;
    - the halo: two collective-permutes of one rank plane, P x
      rank_bytes each;
    - the tet table's ghost segment: one collective-permute of P x 6 x 8
      B;
    - ring resolution: per rotation nb shifts of the two boundary slices
      of the table, 2 x P x ent x 8 B each (ent 1 for vertices, 6 for
      tets);
    - psums / pmaxes of counts and flags (8 B each): the sort's overflow,
      the four critical counts, two unresolved counts, the critical peak.
    """
    axes = tuple(SH.axis_sizes(mesh))
    nb = front_cfg.n_blocks
    P = front_cfg.plane
    nvl = front_cfg.nv_local
    out = []
    if front_cfg.use_sample_sort and nb > 1:
        cap = int(math.ceil(front_cfg.sort_slack * nvl / nb)) * nb
        out += [("all-gather", nb * (nb - 1) * 8, axes),
                ("all-gather", nb * 8, axes),
                ("all-to-all", cap * 16, axes),
                ("all-to-all", cap * 16, axes),
                ("all-reduce", 8, axes)]
    out += [("collective-permute", P * rank_bytes, axes)] * 2
    out.append(("collective-permute", P * 6 * 8, axes))
    for ent in (1, 6):
        rot = front_cfg.ring_rotation_count(ent)
        out += [("collective-permute", 2 * P * ent * 8, axes)] * (rot * nb)
    out += [("all-reduce", 8, axes)] * 7
    return out


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def summary(self) -> str:
        return (f"compute {self.compute_s*1e3:.3f} ms | memory "
                f"{self.memory_s*1e3:.3f} ms | collective "
                f"{self.collective_s*1e3:.3f} ms -> {self.dominant}"
                + (f" | useful {self.useful_ratio:.2f}"
                   if self.useful_ratio else ""))


def analyze(costs, model_flops_per_device: Optional[float] = None,
            peak_flops: float = PEAK_FLOPS) -> Roofline:
    """The three terms of counted per-device ``costs``: ``{"flops",
    "bytes", "collectives"}``, the last as :func:`collective_bytes` gives
    it (its ``seconds`` is the collective term).  ``peak_flops`` is the
    rate the FLOPs run at (the bf16 peak, or INT_OPS_PER_S for the DDMS
    front's integer work)."""
    flops = float(costs["flops"])
    byts = float(costs["bytes"])
    coll = dict(costs["collectives"])
    terms = dict(compute=flops / peak_flops, memory=byts / HBM_BW,
                 collective=float(coll.get("seconds", 0.0)))
    dominant = max(terms, key=terms.get)
    r = Roofline(flops, byts, coll, terms["compute"], terms["memory"],
                 terms["collective"], dominant)
    if model_flops_per_device:
        r.model_flops = model_flops_per_device
        r.useful_ratio = model_flops_per_device / max(flops, 1.0)
    return r


def model_flops(cfg, shape, n_devices: int) -> float:
    """Per-device useful FLOPs of one step (6*N*D train, 2*N decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_devices
    return 2.0 * n_active * shape.global_batch / n_devices
