"""Layer library in plain PyTorch (the counterpart of ``repro.models.layers``):
params are nested dicts of tensors, described by a parallel *meta* tree
carrying shapes + logical sharding axes.

Logical axes (for mapping parameters onto a device mesh):
  embed, mlp, heads, kv, head (per-head feature), vocab, experts, conv,
  state, ssm_heads, lora — plus None for replicated dims.

Compute dtype is bf16 (cast at use), params are kept f32 (master copy);
softmax/normalization accumulate in f32.  The dtypes follow the JAX
package step for step, because they decide the numbers:

- an einsum of bf16 operands returns bf16 (f32 accumulation inside), so
  attention and LM logits are rounded to bf16 before their f32 cast;
- an einsum that mixes bf16 with f32 computes in f32 (``_einsum`` promotes
  the operands as ``jnp.einsum`` does; ``torch.einsum`` refuses mixed
  dtypes);
- elementwise ops promote as JAX promotes (bf16 with f32 gives f32).

Caches are dicts of tensors, replaced and never written in place, as in
the reference.  Every jnp device program of the reference is ported as
the same algorithm in torch ops: the online-softmax ``_flash_sdpa``, the
chunked SSD scan ``ssd_chunked`` and the sort-based MoE dispatch ``moe``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.distributed.tensor as _dtensor

from .config import MLACfg, ModelConfig, MoECfg, SSMCfg

COMPUTE_DTYPE = torch.bfloat16


@dataclass(frozen=True)
class PM:
    """Param meta: shape + logical axes (+ init style)."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones


def init_param(key, pm: PM, scale: float = 0.02):
    """One f32 parameter on the device of ``key`` (a ``torch.Generator``)."""
    if pm.init == "zeros":
        return torch.zeros(pm.shape, dtype=torch.float32, device=key.device)
    if pm.init == "ones":
        return torch.ones(pm.shape, dtype=torch.float32, device=key.device)
    return torch.randn(pm.shape, generator=key, dtype=torch.float32,
                       device=key.device).mul_(scale)


def init_tree(key, meta):
    """Parameters for every ``PM`` of ``meta``, drawn from ``key`` in the
    order of the reference's leaves (dict keys sorted)."""
    if isinstance(meta, PM):
        return init_param(key, meta)
    return {k: init_tree(key, meta[k]) for k in sorted(meta)}


def cast(x):
    return x.to(COMPUTE_DTYPE)


def weight(p):
    """A parameter at use: cast to the compute dtype.  On a mesh (a
    ``DTensor``) the cast copy is then gathered over the batch axes, FSDP's
    all-gather per layer, and keeps its model-axis shards (the layout the
    planner counts); its gradient is reduce-scattered back in the backward
    pass.  A plain tensor is only cast."""
    x = cast(p)
    if isinstance(x, _dtensor.DTensor):
        from repro_torch.train.sharding import gather_batch_axes
        x = gather_batch_axes(x)
        x._repro_weight = True
    return x


def _like(t, ref):
    """``t``, a tensor made inside the forward (positions, a mask, a
    running statistic), for use beside ``ref``: a replicated ``DTensor`` on
    ``ref``'s mesh where ``ref`` is a ``DTensor`` (whose ops take no plain
    tensor beside one), else ``t`` itself."""
    if isinstance(ref, _dtensor.DTensor) \
            and not isinstance(t, _dtensor.DTensor):
        mesh = ref.device_mesh
        return _dtensor.DTensor.from_local(
            t, mesh, [_dtensor.Replicate()] * mesh.ndim, run_check=False)
    return t


def _einsum(eq, *ops):
    """``jnp.einsum``'s dtype rule: the operands are promoted to their
    common type (bf16 with f32 gives f32), which is the result's type.  On
    a mesh (any operand a ``DTensor``) the layout is :func:`_einsum_mesh`'s."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    ops = [o.to(dt) for o in ops]
    if any(isinstance(o, _dtensor.DTensor) for o in ops):
        return _einsum_mesh(eq, ops)
    return torch.einsum(eq, *ops)


def _einsum_mesh(eq, ops):
    """An einsum of ``DTensor``s laid out as GSPMD lays out a dot (tensor
    parallelism): :func:`_on_shards` with the equation's letters, a split
    contracted letter giving partial sums that are all-reduced at once (a
    row-parallel projection).  So activations stay replicated over the
    model axis or sharded on a feature dim, never on the sequence, and the
    values are the one-device einsum's up to the order of the sums."""
    ins, out = eq.replace(" ", "").split("->")
    return _on_shards(lambda *t: torch.einsum(eq, *t), ins.split(","), out,
                      ops, sums=True)


def _on_shards(fn, ins, out, ops, sums=False):
    """``fn`` of the local shards of ``ops`` on a mesh, the result placed
    back: the layout of a computation that runs shard by shard.
    ``ins[i]`` names the dims of ``ops[i]`` by letter (``None``: used
    whole, a mask or a number), ``out`` those of the result.  On each
    mesh dim one letter is split: one that a sharded operand splits (the
    largest such operand's where they differ) and that every operand
    holding it divides evenly, and, unless ``sums``, that the result
    keeps (``out`` may be a tuple, one entry per result of ``fn``: every
    result then keeps it).  Operands holding it take their shard of it (a
    replicated one is sliced in place), the others are used whole (their
    gradients are partial sums), and the rest of the mesh dims are
    gathered.  With ``sums`` a split letter the result lacks makes it a
    partial sum, all-reduced at once.  The gradient of an activation operand comes
    back in its own layout (:func:`_pin_grad`); a weight's (from
    :func:`weight`) is reduce-scattered by its gather."""
    ref = next(o for o in ops if isinstance(o, _dtensor.DTensor))
    mesh = ref.device_mesh
    ops = [_summed(_like(o, ref)) if lets is not None else o
           for o, lets in zip(ops, ins)]
    outs = (out,) if isinstance(out, str) else tuple(out)
    rep = [_dtensor.Replicate()] * mesh.ndim
    want = [list(rep) for _ in ops]
    grad = [list(rep) for _ in ops]
    out_pl = [list(rep) for _ in outs]
    for k in range(mesh.ndim):
        n = mesh.size(k)
        split = {}          # letter -> the largest operand splitting it
        for lets, o in zip(ins, ops):
            pl = o.placements[k] if lets is not None else None
            if pl is not None and pl.is_shard() and (
                    sums or all(lets[pl.dim] in r for r in outs)):
                c = lets[pl.dim]
                split[c] = max(split.get(c, 0), o.numel())
        for c in list(split):
            if any(o.shape[lets.index(c)] % n for lets, o in zip(ins, ops)
                   if lets is not None and c in lets):
                del split[c]
        if not split:
            continue
        c = max(split, key=split.get)
        for i, lets in enumerate(ins):
            if lets is None:
                continue
            if c in lets:
                want[i][k] = grad[i][k] = _dtensor.Shard(lets.index(c))
            else:
                grad[i][k] = _dtensor.Partial()
        for r, pl in zip(outs, out_pl):
            pl[k] = _dtensor.Shard(r.index(c)) if c in r \
                else _dtensor.Partial()
    local = []
    for o, lets, w, g in zip(ops, ins, want, grad):
        if lets is None:
            if isinstance(o, _dtensor.DTensor):
                o = o.redistribute(mesh, rep).to_local()
        else:
            if not getattr(o, "_repro_weight", False):
                o = _pin_grad(o)
            o = o.redistribute(mesh, w).to_local(grad_placements=g)
        local.append(o)
    # every split is even, so from_local infers the global shape and
    # strides (the local result may be a permuted view)
    res = fn(*local)
    res = tuple(_summed(_dtensor.DTensor.from_local(r, mesh, pl,
                                                    run_check=False))
                for r, pl in zip((res,) if isinstance(out, str) else res,
                                 out_pl))
    return res[0] if isinstance(out, str) else res


def _summed(x):
    """A ``DTensor`` holding partial sums (a reduction over a sharded dim)
    all-reduced at once, so that no later op picks its layout, and its
    gradient replicated likewise (:func:`_pin_grad`); anything else as it
    is."""
    if isinstance(x, _dtensor.DTensor) and any(pl.is_partial()
                                      for pl in x.placements):
        return _pin_grad(x.redistribute(x.device_mesh, [
            _dtensor.Replicate() if pl.is_partial() else pl
            for pl in x.placements]))
    return x


def _pin_grad(x):
    """``x`` itself, but on a mesh its gradient in the backward pass is
    brought to ``x``'s own placements first (a partial sum all-reduced);
    left to itself, DTensor's propagation may pick, say, a
    sequence-sharded layout for it, which later reshapes cannot take.
    Off a mesh, ``x`` unchanged."""
    if not isinstance(x, _dtensor.DTensor) or not x.requires_grad \
            or any(pl.is_partial() for pl in x.placements):
        return x
    return _dtensor.DTensor.from_local(
        x.to_local(), x.device_mesh, x.placements, run_check=False,
        shape=x.shape, stride=x.stride())


def _write_slot(buf, val, slot):
    """``buf`` with ``buf[:, slot] = val`` (out of place), as
    ``jax.lax.dynamic_update_index_in_dim`` writes it: XLA clamps the start
    of a dynamic update so that it fits, so a slot past the end writes the
    last one.  Torch indexing would raise there, so the clamp is explicit;
    zamba2's shared cache relies on it (several writes per token overrun
    ``max_len``)."""
    at = torch.clamp(slot, 0, buf.shape[1] - 1).reshape(1).long()
    return buf.index_copy(1, at, val[:, None])


def _resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``cuda`` unless the caller names
    another; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the LM substrate runs on CUDA by default, and CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    return dev


class ParamTree(torch.nn.Module):
    """A nested dict of parameters held as an ``nn.Module``: every leaf an
    ``nn.Parameter`` and every sub-dict a ``ParamTree``, under the
    reference's key names (so ``state_dict`` keys read ``layers.mixer.wq``).
    Layer axes stay stacked as the reference stacks them.  ``tree()`` gives
    the nested dict the layer functions take."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._names = sorted(tree)
        for k in self._names:
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, torch.nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        out = {}
        for k in self._names:
            v = getattr(self, k)
            out[k] = v.tree() if isinstance(v, ParamTree) else v
        return out


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm_meta(d: int) -> Dict[str, PM]:
    return {"scale": PM((d,), ("embed",), "ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    xf = x.float()
    var = _summed(torch.mean(xf * xf, dim=-1, keepdim=True))
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) \
        * weight(params["scale"])


def rope_freqs(hd: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, hd, 2) / hd))


def apply_rope(x, pos, theta: float = 10000.0):
    """x: (..., S, H, hd); pos: (..., S) absolute positions.

    Interleaved (GPT-NeoX 'rotate every two') pairing: rotation pairs are
    adjacent dims (not the half-split rotation of most torch code), so a
    head_dim sharded over the model axis stays local."""
    if isinstance(x, _dtensor.DTensor):
        # on a mesh each rank rotates its shards of the batch and heads
        return _on_shards(lambda x, p: apply_rope(x, p, theta),
                          ["bshd", "bs"], "bshd", [x, pos])
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = pos[..., :, None].float() * freqs               # (..., S, hd/2)
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)[..., None, :]
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)[..., None, :]
    xf = x.float()
    # pairwise rotate: (x0, x1) -> (-x1, x0) on adjacent pairs
    xr = xf.reshape(xf.shape[:-1] + (hd // 2, 2))
    xr = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1)
    xr = xr.reshape(xf.shape)
    return (xf * cos + xr * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA / sliding window)
# ---------------------------------------------------------------------------

def attention_meta(cfg: ModelConfig) -> Dict[str, PM]:
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    m = {
        "wq": PM((d, H, hd), ("embed", "heads", "head")),
        "wk": PM((d, Kv, hd), ("embed", "kv", "head")),
        "wv": PM((d, Kv, hd), ("embed", "kv", "head")),
        "wo": PM((H, hd, d), ("heads", "head", "embed")),
    }
    if cfg.qkv_bias:
        m["bq"] = PM((H, hd), ("heads", "head"), "zeros")
        m["bk"] = PM((Kv, hd), ("kv", "head"), "zeros")
        m["bv"] = PM((Kv, hd), ("kv", "head"), "zeros")
    return m


def _gqa_heads(q, kv: int):
    """``q`` (B, S, H, hd), ready to split its H heads into (``kv``, H /
    ``kv``): a ``DTensor`` whose heads are sharded over devices that do
    not divide ``kv`` (the KV heads, replicated then) has its heads
    gathered first.  Off a mesh, ``q`` itself."""
    if not isinstance(q, _dtensor.DTensor):
        return q
    mesh = q.device_mesh
    n = 1
    for k, pl in enumerate(q.placements):
        if pl.is_shard(2):
            n *= mesh.size(k)
    if kv % n == 0:
        return q
    return q.redistribute(mesh, [_dtensor.Replicate() if pl.is_shard(2) else pl
                                 for pl in q.placements])


def _sdpa(q, k, v, mask):
    """Materialized-logits attention (short sequences / decode).
    q: (B,S,H,hd); k,v: (B,T,Kv,hd); mask broadcastable to (B,Kv,rep,S,T)."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    rep = H // Kv
    qs = q.reshape(B, S, Kv, rep, hd)
    logits = _einsum("bskrh,btkh->bkrst", qs, k).float()
    logits = logits * float(np.float32(1.0 / np.sqrt(hd)))
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = _einsum("bkrst,btkh->bskrh", w, v)
    return o.reshape(B, S, H, v.shape[-1])   # v dim may differ (MLA)


FLASH_THRESHOLD = 2048   # sequences above this use the chunked path
FLASH_QC = 512
FLASH_KC = 1024
CAUSAL_BLOCK_SKIP = True  # skip fully-masked kv blocks (static triangle)
FLASH_UNROLL = False      # the reference's dry-run unroll; no effect here


def _flash_sdpa(q, k, v, causal: bool, window=None,
                qc: int = None, kc: int = None):
    """Online-softmax (flash) attention in torch ops: an outer q-chunk loop
    (static causal triangle skip) and an inner loop over kv chunks with
    running (max, denom, acc), as the reference's ``lax.scan``.  Never
    materializes (S, T) logits."""
    qc = qc or FLASH_QC
    kc = kc or FLASH_KC
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    dv = v.shape[-1]
    Sp = -(-S // qc) * qc
    Tp = -(-T // kc) * kc
    qp = F.pad(q, (0, 0, 0, 0, 0, Sp - S)) if Sp > S else q
    kp = F.pad(k, (0, 0, 0, 0, 0, Tp - T)) if Tp > T else k
    vp = F.pad(v, (0, 0, 0, 0, 0, Tp - T)) if Tp > T else v
    nq, nk = Sp // qc, Tp // kc
    kb = kp.reshape(B, nk, kc, Kv, hd)
    vb = vp.reshape(B, nk, kc, Kv, dv)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    dev = q.device

    outs = []
    for qi in range(nq):
        qblk = qp[:, qi * qc:(qi + 1) * qc].reshape(B, qc, Kv, rep, hd)
        q_pos = qi * qc + torch.arange(qc, device=dev)
        hi = min(nk, (qi + 1) * qc // kc + (1 if (qi + 1) * qc % kc else 0)) \
            if (causal and CAUSAL_BLOCK_SKIP) else nk
        lo = 0
        if causal and window is not None and CAUSAL_BLOCK_SKIP:
            lo = max(0, (qi * qc - window) // kc)
        m = torch.full((B, Kv, rep, qc), -torch.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Kv, rep, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kv, rep, qc, dv), dtype=torch.float32,
                          device=dev)
        for ki in range(lo, hi):
            kblk = kb[:, ki]                          # (B,kc,Kv,hd)
            vblk = vb[:, ki]
            s = _einsum("bqkrh,btkh->bkrqt", qblk, kblk).float() * scale
            k_pos = ki * kc + torch.arange(kc, device=dev)
            ok = (k_pos < T)[None, :]
            if causal:
                ok = ok & (q_pos[:, None] >= k_pos[None, :])
                if window is not None:
                    ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(ok, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(ok, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _einsum(
                "bkrqt,btkh->bkrqh", p.to(vblk.dtype), vblk)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, qc, H, dv))
    out = torch.cat(outs, dim=1)[:, :S]
    return out.to(v.dtype)


def sdpa(q, k, v, *, causal: bool, window=None, mask=None):
    """Dispatch: flash for long sequences, materialized otherwise.
    ``mask`` (decode write-mask etc.) forces the materialized path.  On a
    mesh each rank attends with its shards of the batch and the heads
    (:func:`_on_shards`; the query heads gathered first where the KV heads
    cannot split as they do)."""
    if isinstance(q, _dtensor.DTensor):
        return _on_shards(
            lambda q, k, v, m: sdpa(q, k, v, causal=causal, window=window,
                                    mask=m),
            ["bshd", "bthd", "bthe", None], "bshe",
            [_gqa_heads(q, k.shape[2]), k, v, mask])
    if mask is None and q.shape[1] > FLASH_THRESHOLD:
        return _flash_sdpa(q, k, v, causal, window)
    if mask is None:
        S, T = q.shape[1], k.shape[1]
        spans_q = torch.arange(S, device=q.device)
        spans_k = torch.arange(T, device=q.device)
        if causal:
            m = spans_q[:, None] >= spans_k[None, :]
            if window is not None:
                m &= (spans_q[:, None] - spans_k[None, :]) < window
        else:
            m = torch.ones((S, T), dtype=torch.bool, device=q.device)
        mask = m[None, None, None]
    return _sdpa(q, k, v, mask)


def attention(cfg: ModelConfig, params, x, pos, cache=None):
    """Causal (optionally sliding-window) GQA.

    Train/prefill: cache=None, full sequence.  Decode: cache is a dict with
    k/v ring buffers and `idx` (tokens written so far); x is (B,1,d)."""
    B, S, d = x.shape
    q = _einsum("bsd,dhk->bshk", x, weight(params["wq"]))
    k = _einsum("bsd,dhk->bshk", x, weight(params["wk"]))
    v = _einsum("bsd,dhk->bshk", x, weight(params["wv"]))
    if cfg.qkv_bias:
        q = q + weight(params["bq"])
        k = k + weight(params["bk"])
        v = v + weight(params["bv"])
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    if cache is None:
        o = sdpa(q, k, v, causal=True, window=cfg.window)
    else:
        T = cache["k"].shape[1]
        slot = cache["idx"] % T if cfg.window is not None else cache["idx"]
        ck = _write_slot(cache["k"], k[:, 0], slot)
        cv = _write_slot(cache["v"], v[:, 0], slot)
        cache = dict(cache, k=ck, v=cv, idx=cache["idx"] + 1)
        span = torch.arange(T, device=x.device)
        written = span <= slot if cfg.window is None else \
            span < torch.clamp(cache["idx"], max=T)
        o = sdpa(q, ck, cv, causal=False,
                 mask=written[None, None, None, None, :])
    out = _einsum("bshk,hkd->bsd", o, weight(params["wo"]))
    return out, cache


def attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device=None):
    T = min(max_len, cfg.window) if cfg.window is not None else max_len
    shp = (batch, T, cfg.n_kv, cfg.hd)
    dev = _resolve_device(device)
    return {"k": torch.zeros(shp, dtype=COMPUTE_DTYPE, device=dev),
            "v": torch.zeros(shp, dtype=COMPUTE_DTYPE, device=dev),
            "idx": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3/DeepSeek style)
# ---------------------------------------------------------------------------

def mla_meta(cfg: ModelConfig) -> Dict[str, PM]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wdq": PM((d, m.q_lora), ("embed", "lora")),
        "q_norm": rmsnorm_meta(m.q_lora)["scale"],
        "wuq": PM((m.q_lora, H, m.qk_nope + m.qk_rope),
                  ("lora", "heads", "head")),
        "wdkv": PM((d, m.kv_lora + m.qk_rope), ("embed", "lora")),
        "kv_norm": rmsnorm_meta(m.kv_lora)["scale"],
        "wukv": PM((m.kv_lora, H, m.qk_nope + m.v_head),
                   ("lora", "heads", "head")),
        "wo": PM((H, m.v_head, d), ("heads", "head", "embed")),
    }


def mla_attention(cfg: ModelConfig, params, x, pos, cache=None):
    if cache is not None and MLA_ABSORBED_DECODE:
        return mla_attention_absorbed(cfg, params, x, pos, cache)
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.n_heads
    cq = rmsnorm({"scale": params["q_norm"]},
                 _einsum("bsd,dl->bsl", x, weight(params["wdq"])))
    q = _einsum("bsl,lhk->bshk", cq, weight(params["wuq"]))
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    dkv = _einsum("bsd,dl->bsl", x, weight(params["wdkv"]))
    c_kv, k_rope1 = dkv[..., :m.kv_lora], dkv[..., m.kv_lora:]
    c_kv = rmsnorm({"scale": params["kv_norm"]}, c_kv)
    k_rope1 = apply_rope(k_rope1[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        slot = cache["idx"]
        cc = _write_slot(cache["c"], c_kv[:, 0], slot)
        cr = _write_slot(cache["r"], k_rope1[:, 0], slot)
        cache = dict(cache, c=cc, r=cr, idx=cache["idx"] + 1)
        c_all, r_all = cc, cr
        T = cc.shape[1]
        mask = (torch.arange(T, device=x.device) <= slot)[
            None, None, None, None, :]
    else:
        c_all, r_all = c_kv, k_rope1
        mask = None

    kv = _einsum("btl,lhk->bthk", c_all, weight(params["wukv"]))
    k_nope, vv = kv[..., :m.qk_nope], kv[..., m.qk_nope:]
    k = torch.cat(
        [k_nope, r_all[:, :, None, :].expand(
            k_nope.shape[:-1] + (m.qk_rope,))], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    o = sdpa(qfull, k, vv, causal=True, mask=mask)
    out = _einsum("bshk,hkd->bsd", o, weight(params["wo"]))
    return out, cache


def mla_attention_absorbed(cfg: ModelConfig, params, x, pos, cache):
    """Decode-path MLA with the *absorbed* up-projection (DeepSeek-V2
    trick): W_ukv is folded into the per-head query/output maps, so
    attention contracts directly against the compressed latent cache
    (B, T, kv_lora) instead of re-materializing per-head K/V over the
    whole history every step.  O(T * kv_lora) work/bytes per head instead
    of O(T * (qk_nope + v_head)) re-projection.

    Equal to ``mla_attention`` up to bf16 rounding (held by the tests)."""
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.n_heads
    if cache is None or S != 1:
        raise ValueError("absorbed MLA decodes one token against a cache")
    cq = rmsnorm({"scale": params["q_norm"]},
                 _einsum("bsd,dl->bsl", x, weight(params["wdq"])))
    q = _einsum("bsl,lhk->bshk", cq, weight(params["wuq"]))
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    dkv = _einsum("bsd,dl->bsl", x, weight(params["wdkv"]))
    c_kv, k_rope1 = dkv[..., :m.kv_lora], dkv[..., m.kv_lora:]
    c_kv = rmsnorm({"scale": params["kv_norm"]}, c_kv)
    k_rope1 = apply_rope(k_rope1[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]

    slot = cache["idx"]
    cc = _write_slot(cache["c"], c_kv[:, 0], slot)
    cr = _write_slot(cache["r"], k_rope1[:, 0], slot)
    cache = dict(cache, c=cc, r=cr, idx=cache["idx"] + 1)
    T = cc.shape[1]

    wukv = weight(params["wukv"])                      # (lora, H, nope+v)
    wk = wukv[..., :m.qk_nope]                       # (lora, H, nope)
    wv = wukv[..., m.qk_nope:]                       # (lora, H, v)
    # absorb: q_eff[l] = sum_k q_nope[k] * wk[l,h,k]
    q_eff = _einsum("bshk,lhk->bshl", q_nope, wk)       # (B,1,H,lora)
    s_lat = _einsum("bshl,btl->bhst", q_eff, cc)        # latent scores
    s_rope = _einsum("bshk,btk->bhst", q_rope, cr)
    scale = float(np.float32(1.0 / np.sqrt(m.qk_nope + m.qk_rope)))
    logits = (s_lat + s_rope).float() * scale
    mask = (torch.arange(T, device=x.device) <= slot)[None, None, None, :]
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(cc.dtype)
    o_lat = _einsum("bhst,btl->bshl", w, cc)            # (B,1,H,lora)
    o = _einsum("bshl,lhk->bshk", o_lat, wv)            # (B,1,H,v)
    out = _einsum("bshk,hkd->bsd", o, weight(params["wo"]))
    return out, cache


MLA_ABSORBED_DECODE = False  # flipped by launchers / experiments


def mla_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    m = cfg.mla
    dev = _resolve_device(device)
    return {"c": torch.zeros((batch, max_len, m.kv_lora),
                             dtype=COMPUTE_DTYPE, device=dev),
            "r": torch.zeros((batch, max_len, m.qk_rope),
                             dtype=COMPUTE_DTYPE, device=dev),
            "idx": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# MLPs / MoE
# ---------------------------------------------------------------------------

def mlp_meta(cfg: ModelConfig) -> Dict[str, PM]:
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": PM((d, f), ("embed", "mlp")),
            "wu": PM((d, f), ("embed", "mlp")),
            "wd": PM((f, d), ("mlp", "embed"))}


def mlp(params, x):
    g = _einsum("bsd,df->bsf", x, weight(params["wg"]))
    u = _einsum("bsd,df->bsf", x, weight(params["wu"]))
    return _einsum("bsf,fd->bsd", F.silu(g) * u, weight(params["wd"]))


def moe_meta(cfg: ModelConfig) -> Dict[str, PM]:
    d = cfg.d_model
    mo = cfg.moe
    E, fe = mo.n_experts, mo.d_expert
    return {"router": PM((d, E), ("embed", "experts")),
            "wg": PM((E, d, fe), ("experts", "embed", "mlp")),
            "wu": PM((E, d, fe), ("experts", "embed", "mlp")),
            "wd": PM((E, fe, d), ("experts", "mlp", "embed"))}


def _whole(t):
    """``t`` whole on this rank: a ``DTensor`` replicated and taken as its
    local tensor (differentiable both ways), a plain tensor as it is."""
    if not isinstance(t, _dtensor.DTensor):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, [_dtensor.Replicate()] * mesh.ndim).to_local()


def _placed_as(t, ref):
    """``t``, whole on every rank, placed as the ``DTensor`` ``ref`` (its
    partial sums as replicas; a plain ``ref``: ``t`` itself)."""
    if not isinstance(ref, _dtensor.DTensor):
        return t
    return _like(t, ref).redistribute(
        ref.device_mesh, [_dtensor.Replicate() if pl.is_partial() else pl
                          for pl in ref.placements])


def _gate(logits, k: int):
    """(probs, gate values, expert ids) of router logits: softmax, top-k,
    the top k renormalized."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)        # (B,S,k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return probs, gate_vals, gate_idx


def moe(cfg: ModelConfig, params, x):
    """Capacity-based top-k MoE with *sort-based* dispatch: token-choice
    assignments are ranked within their expert queue via a stable argsort
    + per-expert counts (O(T log T), no (T, E) or (T, E, cap) tensors;
    the counts are a ``scatter_add_`` of ones into E zeros, the reference's
    ``bincount`` in a form whose output shape does not depend on the
    data, so the step also runs on fake tensors for the planner), scattered
    into an (E*cap, d) buffer, run through the expert FFNs, and gathered
    back.  Returns (out, aux_loss)."""
    mo = cfg.moe
    B, S, d = x.shape
    E, k = mo.n_experts, mo.top_k
    logits = _einsum("bsd,de->bse", x, weight(params["router"])).float()
    if isinstance(logits, _dtensor.DTensor):
        # on a mesh each rank gates its own tokens (all experts' logits)
        probs, gate_vals, gate_idx = _on_shards(
            lambda lg: _gate(lg, k), ["bse"], ("bse", "bsk", "bsk"),
            [logits])
    else:
        probs, gate_vals, gate_idx = _gate(logits, k)
    cap = int(np.ceil(mo.capacity_factor * B * S * k / E))

    Tk = B * S * k
    # the routing needs every token's expert id, as under GSPMD: on a mesh
    # it runs on a replicated copy (``_whole``), and the result is placed
    # as ``x`` again (``_placed_as``)
    expert = _whole(gate_idx).reshape(Tk)
    # position within expert queue: rank by stable sort over expert id
    order = torch.argsort(expert, stable=True)                # (Tk,)
    counts = torch.zeros(E, dtype=expert.dtype, device=x.device) \
        .scatter_add_(0, expert, torch.ones_like(expert))
    starts = torch.cumsum(counts, 0) - counts                 # (E,)
    pos_sorted = torch.arange(Tk, device=x.device) - starts[expert[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, expert * cap + pos, E * cap)     # dump slot

    xf = _whole(x).reshape(B * S, 1, d).expand(B * S, k, d).reshape(Tk, d)
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device) \
        .index_put((slot,), xf)
    xe = _like(buf[:E * cap].reshape(E, cap, d), x)
    h = F.silu(_einsum("ecd,edf->ecf", xe, weight(params["wg"]))) \
        * _einsum("ecd,edf->ecf", xe, weight(params["wu"]))
    ye = _einsum("ecf,efd->ecd", h, weight(params["wd"]))
    yf = _whole(ye.reshape(E * cap, d))
    ytok = torch.where(keep[:, None], yf[torch.clamp(slot, max=E * cap - 1)],
                       0.0)
    out = (ytok.reshape(B * S, k, d)
           * _whole(gate_vals).reshape(B * S, k, 1).to(x.dtype)).sum(1)
    out = _placed_as(out.reshape(B, S, d), x)
    # load-balancing aux loss (Switch style)
    frac_tokens = _like(counts.float() / Tk, probs)
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out, aux


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_meta(cfg: ModelConfig) -> Dict[str, PM]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    N = s.d_state
    return {
        "in_proj": PM((d, 2 * di + 2 * N + nh), ("embed", "mlp")),
        "conv_w": PM((s.d_conv, di + 2 * N), ("conv", "mlp")),
        "conv_b": PM((di + 2 * N,), ("mlp",), "zeros"),
        "A_log": PM((nh,), ("ssm_heads",), "ones"),
        "D": PM((nh,), ("ssm_heads",), "ones"),
        "dt_bias": PM((nh,), ("ssm_heads",), "zeros"),
        "norm": rmsnorm_meta(di)["scale"],
        "out_proj": PM((di, d), ("mlp", "embed")),
    }


def _segsum(x):
    """(..., L) -> (..., L, L) lower-triangular segment sums."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, -torch.inf)


def ssd_chunked(x, a, B, C, chunk):
    """Minimal SSD (Mamba-2 paper, listing 1) in torch ops.

    x: (b,l,h,p); a: (b,l,h) = dt*(-exp(A_log)); B,C: (b,l,n).
    Returns y: (b,l,h,p), in f32 when ``a`` is f32 (the einsums promote).
    ``l`` must be a multiple of ``chunk``, as in the reference (no
    padding)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_chunked: length {l} is not a multiple of "
                         f"the chunk {chunk}")
    c = l // chunk
    xr = x.reshape(b, c, chunk, h, p)
    ar = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # (b,h,c,l)
    Br = B.reshape(b, c, chunk, n)
    Cr = C.reshape(b, c, chunk, n)
    a_cum = torch.cumsum(ar, dim=-1)
    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(ar))                            # (b,h,c,l,l)
    Y_diag = _einsum("bcsn,bczn,bhcsz,bczhp->bcshp", Cr, Br, L, xr)
    # 2. chunk states
    decay = torch.exp(a_cum[..., -1:] - a_cum)            # (b,h,c,l)
    states = _einsum("bczn,bhcz,bczhp->bchpn", Br, decay, xr)
    # 3. inter-chunk recurrence (initial state prepended, à la listing 1)
    states_cat = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    new_states = _einsum("bhzc,bchpn->bzhpn", chunk_decay, states_cat)
    states_in = new_states[:, :-1]                    # state at chunk start
    # 4. state -> output
    out_decay = torch.exp(a_cum)                          # (b,h,c,l)
    Y_off = _einsum("bcsn,bchpn,bhcs->bcshp", Cr, states_in, out_decay)
    return (Y_diag + Y_off).reshape(b, l, h, p)


def mamba2(cfg: ModelConfig, params, x, cache=None):
    zxbcdt = _einsum("bsd,de->bse", x, weight(params["in_proj"]))
    if cache is None and isinstance(zxbcdt, _dtensor.DTensor):
        # on a mesh each rank mixes its own rows, every feature and head
        # (the split of the projection does not follow the model shards)
        names = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm")
        y = _on_shards(
            lambda t, *w: _mamba2_mix(cfg, dict(zip(names, w)), t, None)[0],
            ["bsf", "kc", "c", "h", "h", "h", "e"], "bse",
            [zxbcdt] + [params[k] for k in names])
    else:
        y, cache = _mamba2_mix(cfg, params, zxbcdt, cache)
    return _einsum("bsd,de->bse", y, weight(params["out_proj"])), cache


def _mamba2_mix(cfg: ModelConfig, params, zxbcdt, cache):
    """The SSM block between its projections: (y, cache)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    N = s.d_state
    B_, S, _ = zxbcdt.shape
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [di, di, N, N, nh], dim=-1)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)                # conv features
    w = weight(params["conv_w"])                            # (K, di+2N)
    if cache is None:
        pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
        conv = sum(pad[:, i:i + S] * w[i] for i in range(s.d_conv))
        conv = F.silu(conv + weight(params["conv_b"]))
    else:
        buf = torch.cat([cache["conv"], xbc], dim=1)[:, 1:]
        conv = F.silu((buf * w[None]).sum(1, keepdim=True)
                      + weight(params["conv_b"]))
        cache = dict(cache, conv=buf)
    xin, Bc, Cc = torch.split(conv, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())               # (nh,)
    xh = xin.reshape(B_, S, nh, s.head_dim)
    if cache is None:
        a = dt * A                                        # (b,l,nh)
        y = ssd_chunked(xh * dt[..., None].to(xh.dtype), a.float(), Bc, Cc,
                        min(s.chunk, S))
    else:
        # the state starts bf16 (mamba2_cache) and is f32 from the first
        # step on: bf16 state x f32 decay promotes, as in the reference
        st = cache["state"]                               # (b,nh,p,n)
        da = torch.exp(dt[:, 0] * A)                      # (b,nh)
        upd = _einsum("bhp,bn->bhpn", xh[:, 0] * dt[:, 0, :, None]
                      .to(xh.dtype), Bc[:, 0])
        st = st * da[..., None, None] + upd
        y = _einsum("bhpn,bn->bhp", st, Cc[:, 0])[:, None]
        cache = dict(cache, state=st)
        y = y.reshape(B_, 1, nh, s.head_dim)
    y = y + xh * params["D"].to(xh.dtype)[:, None]
    y = y.reshape(B_, S, di)
    return rmsnorm({"scale": params["norm"]}, y * F.silu(z)), cache


def mamba2_cache(cfg: ModelConfig, batch: int, device=None):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    dev = _resolve_device(device)
    return {"conv": torch.zeros((batch, s.d_conv, di + 2 * s.d_state),
                                dtype=COMPUTE_DTYPE, device=dev),
            "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                                 dtype=COMPUTE_DTYPE, device=dev)}
