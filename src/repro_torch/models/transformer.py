"""Model stacks in PyTorch (the counterpart of ``repro.models.transformer``):
decoder-only LM (dense / MoE / SSM / hybrid), enc-dec (whisper-style) and
VLM (patch-embedding prefix).

Per-layer parameters stay stacked on a leading layer axis, as the
reference stacks them for ``lax.scan``; a Python loop over
``range(n_layers)`` indexes that axis in place of the scan.

Hybrid (zamba2): every layer is an SSM block; every ``shared_attn_every``-th
layer additionally runs one *shared* attention block (single param set
reused — the zamba2 weight-sharing scheme).

``params`` is a :class:`~repro_torch.models.layers.ParamTree` (what
:func:`init_params` returns) or the nested dict of tensors it holds.
Everything runs on the device of the parameters.

The reference's activation-sharding hooks (``_constrain``) sit at the same
places: the embedded inputs, each block's output and the logits.  They do
nothing unless ``repro_torch.train.sharding.set_rules`` installed rules.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed.tensor as _dtensor

from . import layers as L
from .config import ModelConfig
from .layers import PM, cast


def _constrain(x, kind):
    from repro_torch.train.sharding import constrain
    return constrain(x, kind)


def _params(params):
    return params.tree() if isinstance(params, L.ParamTree) else params


def _map_meta(fn, meta):
    if isinstance(meta, PM):
        return fn(meta)
    return {k: _map_meta(fn, v) for k, v in meta.items()}


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (the scan's per-step slice)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# meta construction
# ---------------------------------------------------------------------------

def _block_meta(cfg: ModelConfig) -> Dict[str, Any]:
    m: Dict[str, Any] = {"ln1": L.rmsnorm_meta(cfg.d_model)}
    if cfg.ssm is not None:
        m["mixer"] = L.mamba2_meta(cfg)
    elif cfg.mla is not None:
        m["mixer"] = L.mla_meta(cfg)
    else:
        m["mixer"] = L.attention_meta(cfg)
    if cfg.ssm is None:
        m["ln2"] = L.rmsnorm_meta(cfg.d_model)
        m["ffn"] = L.moe_meta(cfg) if cfg.moe is not None else \
            L.mlp_meta(cfg)
    return m


def _enc_block_meta(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": L.rmsnorm_meta(cfg.d_model),
            "attn": L.attention_meta(cfg),
            "ln2": L.rmsnorm_meta(cfg.d_model),
            "ffn": L.mlp_meta(cfg)}


def _dec_block_meta(cfg: ModelConfig) -> Dict[str, Any]:
    m = _enc_block_meta(cfg)
    m["ln_x"] = L.rmsnorm_meta(cfg.d_model)
    m["xattn"] = L.attention_meta(cfg)
    return m


def _stack(meta, n: int):
    return _map_meta(
        lambda pm: PM((n,) + pm.shape, ("layers",) + pm.axes, pm.init), meta)


def lm_meta(cfg: ModelConfig) -> Dict[str, Any]:
    meta: Dict[str, Any] = {
        "embed": PM((cfg.vocab_padded, cfg.d_model), ("vocab", "embed")),
        "ln_f": L.rmsnorm_meta(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        meta["unembed"] = PM((cfg.d_model, cfg.vocab_padded),
                             ("embed", "vocab"))
    if cfg.enc_dec:
        meta["enc"] = _stack(_enc_block_meta(cfg), cfg.enc_layers)
        meta["enc_ln"] = L.rmsnorm_meta(cfg.d_model)
        meta["layers"] = _stack(_dec_block_meta(cfg), cfg.n_layers)
    else:
        meta["layers"] = _stack(_block_meta(cfg), cfg.n_layers)
    if cfg.shared_attn_every:
        meta["shared_attn"] = {"ln": L.rmsnorm_meta(cfg.d_model),
                               "attn": L.attention_meta(cfg)}
    if cfg.frontend == "vision_stub":
        meta["patch_proj"] = PM((cfg.d_model, cfg.d_model),
                                ("embed", "embed2"))
    if cfg.frontend == "audio_stub":
        meta["frame_proj"] = PM((cfg.d_model, cfg.d_model),
                                ("embed", "embed2"))
    return meta


def init_params(cfg: ModelConfig, key=0, *, device=None) -> L.ParamTree:
    """Seeded f32 parameters as a :class:`ParamTree` on ``device`` (``cuda``
    unless named).  ``key`` is an int seed or a ``torch.Generator`` on that
    device; ``jax.random`` streams cannot be matched, so the values differ
    from the reference's for the same seed (carry a tree across with
    :func:`repro_torch.models.convert.params_from_jax`)."""
    dev = L._resolve_device(device)
    if isinstance(key, torch.Generator):
        if key.device.type != dev.type:
            raise ValueError(f"the generator is on {key.device}, the "
                             f"parameters go to {dev}")
        gen = key
    else:
        gen = torch.Generator(device=dev).manual_seed(int(key))
    return L.ParamTree(L.init_tree(gen, lm_meta(cfg)))


def abstract_params(cfg: ModelConfig):
    """``meta``-device f32 tensors (shape only, no storage) for every
    parameter — used by the dry-run."""
    return _map_meta(lambda pm: torch.empty(pm.shape, dtype=torch.float32,
                                            device="meta"), lm_meta(cfg))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _block_apply(cfg: ModelConfig, p, x, pos, shared, layer_idx):
    """One decoder block, training/prefill path (no caches)."""
    aux = L._like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.ssm is not None:
        mix, _ = L.mamba2(cfg, p["mixer"], h, None)
    elif cfg.mla is not None:
        mix, _ = L.mla_attention(cfg, p["mixer"], h, pos, None)
    else:
        mix, _ = L.attention(cfg, p["mixer"], h, pos, None)
    x = x + mix.to(x.dtype)
    if cfg.ssm is None:
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            f, aux = L.moe(cfg, p["ffn"], h)
        else:
            f = L.mlp(p["ffn"], h)
        x = x + f.to(x.dtype)
    if cfg.shared_attn_every and shared is not None \
            and layer_idx % cfg.shared_attn_every == 0:
        h = L.rmsnorm(shared["ln"], x, cfg.norm_eps)
        a, _ = L.attention(cfg, shared["attn"], h, pos, None)
        x = x + a.to(x.dtype)
    return x, aux


def _run_block(fn, remat: bool, *args):
    """``fn(*args)``, rematerialized in the backward pass when ``remat``
    (peak activation memory is one block, not the stack)."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _unembed(cfg: ModelConfig, params, x):
    unemb = params.get("unembed")
    w = L.weight(unemb) if unemb is not None else L.weight(params["embed"]).T
    logits = L._einsum("bsd,dv->bsv", x, w).float()
    # mask the padded vocab tail (vocab is padded for clean TP sharding)
    if cfg.vocab_padded != cfg.vocab:
        logits = torch.where(L._like(
            torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab, x),
            logits, -1e30)
    return logits


def _embed(params, tokens):
    """``cast(embed)[tokens]``, gathered before the cast (same values, and
    only the gathered rows are converted)."""
    emb = params["embed"]
    if isinstance(emb, _dtensor.DTensor):
        return cast(_embed_mesh(emb, tokens))
    return cast(emb[torch.as_tensor(tokens, device=emb.device).long()])


def _embed_mesh(emb, tokens):
    """The f32 rows of ``tokens`` from a ``DTensor`` embedding table on a
    mesh (vocab parallel): the table gathered over the batch axes (FSDP,
    as :func:`layers.weight` gathers, in f32 so that the rows' gradient
    sums in f32 as off a mesh), each rank looks up the tokens its vocab
    shard holds, and the rows are summed over the vocab split (one rank
    holds each row, so the sum is exact)."""
    from repro_torch.train.sharding import gather_batch_axes
    table = gather_batch_axes(emb)
    mesh = table.device_mesh
    tokens = L._like(torch.as_tensor(tokens, device=table.device).long(),
                     table)
    # the tokens' layout on every mesh dim the vocab is not split over
    tok_pl, out_pl, grad_pl = [], [], []
    lo, n = 0, table.to_local().shape[0]
    for k, (pt, pe) in enumerate(zip(tokens.placements, table.placements)):
        if pe.is_shard(0):
            tok_pl.append(_dtensor.Replicate())
            out_pl.append(_dtensor.Partial())
            grad_pl.append(pe)
            lo = lo * mesh.size(k) + mesh.get_coordinate()[k]
        elif pe.is_shard():
            raise ValueError(f"embedding table split on dim {pe.dim} over "
                             f"mesh dim {k} after the FSDP gather")
        else:
            tp = pt if pt.is_shard() else _dtensor.Replicate()
            tok_pl.append(tp)
            out_pl.append(tp)
            grad_pl.append(_dtensor.Partial() if tp.is_shard()
                           else _dtensor.Replicate())
    idx = tokens.redistribute(mesh, tok_pl).to_local() - lo * n
    held = (idx >= 0) & (idx < n)
    rows = table.to_local(grad_placements=grad_pl)[idx.clamp(0, n - 1)]
    rows = torch.where(held[..., None], rows, 0.0)
    return L._summed(_dtensor.DTensor.from_local(rows, mesh, out_pl,
                                          run_check=False))


def _embed_inputs(cfg: ModelConfig, params, tokens, frontend_embeds):
    x = _embed(params, tokens)
    if cfg.frontend == "vision_stub" and frontend_embeds is not None:
        fe = torch.as_tensor(frontend_embeds, device=x.device)
        pe = L._einsum("bpd,de->bpe", cast(fe), L.weight(params["patch_proj"]))
        x = torch.cat([pe, x], dim=1)
    return x


def lm_apply(cfg: ModelConfig, params, tokens, frontend_embeds=None,
             remat: bool = False):
    """Training/prefill forward: logits (B, S', vocab) (f32) and the MoE
    aux loss.  For enc-dec, frontend_embeds are the encoder frame
    embeddings.  ``remat=True`` checkpoints each block."""
    params = _params(params)
    if cfg.enc_dec:
        return _encdec_apply(cfg, params, tokens, frontend_embeds, remat)
    x = _constrain(_embed_inputs(cfg, params, tokens, frontend_embeds),
                   "tokens")
    B, S, _ = x.shape
    pos = L._like(torch.arange(S, device=x.device).expand(B, S), x)
    shared = params.get("shared_attn")
    aux = L._like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    for i in range(cfg.n_layers):
        x, a = _run_block(functools.partial(_block_apply, cfg), remat,
                          _index(params["layers"], i), x, pos, shared, i)
        x = _constrain(x, "tokens")
        aux = aux + a
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _constrain(_unembed(cfg, params, x), "logits"), aux


def _enc_block(cfg, p, x):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    # bidirectional self-attention: full mask
    q = L._einsum("bsd,dhk->bshk", h, L.weight(p["attn"]["wq"]))
    k = L._einsum("bsd,dhk->bshk", h, L.weight(p["attn"]["wk"]))
    v = L._einsum("bsd,dhk->bshk", h, L.weight(p["attn"]["wv"]))
    o = L.sdpa(q, k, v, causal=False)
    x = x + L._einsum("bshk,hkd->bsd", o,
                      L.weight(p["attn"]["wo"])).to(x.dtype)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["ffn"], h).to(x.dtype)


def _encoder_apply(cfg: ModelConfig, params, frames, remat: bool = False):
    """frames: (B, T_enc, d) precomputed frame embeddings (conv stub)."""
    params = _params(params)
    frames = torch.as_tensor(frames, device=params["frame_proj"].device)
    x = L._einsum("btd,de->bte", cast(frames), L.weight(params["frame_proj"]))
    for i in range(cfg.enc_layers):
        x = _constrain(_run_block(functools.partial(_enc_block, cfg), remat,
                                  _index(params["enc"], i), x), "tokens")
    return L.rmsnorm(params["enc_ln"], x, cfg.norm_eps)


def _cross_attend(cfg, p, x, enc_kv):
    q = L._einsum("bsd,dhk->bshk", x, L.weight(p["wq"]))
    o = L.sdpa(q, enc_kv["k"], enc_kv["v"], causal=False)
    return L._einsum("bshk,hkd->bsd", o, L.weight(p["wo"]))


def _enc_kv(p, enc_out):
    return {"k": L._einsum("btd,dhk->bthk", enc_out, L.weight(p["wk"])),
            "v": L._einsum("btd,dhk->bthk", enc_out, L.weight(p["wv"]))}


def _dec_block(cfg, p, x, pos, enc_out):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, _ = L.attention(cfg, p["attn"], h, pos, None)
    x = x + a.to(x.dtype)
    h = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
    x = x + _cross_attend(cfg, p["xattn"], h,
                          _enc_kv(p["xattn"], enc_out)).to(x.dtype)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["ffn"], h).to(x.dtype)


def _encdec_apply(cfg: ModelConfig, params, tokens, frames,
                  remat: bool = False):
    enc_out = _encoder_apply(cfg, params, frames, remat)
    x = _constrain(_embed(params, tokens), "tokens")
    B, S, _ = x.shape
    pos = L._like(torch.arange(S, device=x.device).expand(B, S), x)
    for i in range(cfg.n_layers):
        x = _constrain(_run_block(functools.partial(_dec_block, cfg), remat,
                                  _index(params["layers"], i), x, pos,
                                  enc_out), "tokens")
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _constrain(_unembed(cfg, params, x), "logits"), \
        L._like(torch.zeros((), dtype=torch.float32, device=x.device), x)


# ---------------------------------------------------------------------------
# decode (one token with caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeroed decode caches on ``device`` (``cuda`` unless named): per-layer
    caches stacked on a leading layer axis, ``pos``, zamba2's one shared
    attention cache and whisper's encoder output."""
    dev = L._resolve_device(device)
    n = cfg.n_layers

    def stackc(c):
        return {k: v.expand((n,) + v.shape).clone() for k, v in c.items()}

    if cfg.ssm is not None:
        cache = stackc(L.mamba2_cache(cfg, batch, dev))
    elif cfg.mla is not None:
        cache = stackc(L.mla_cache(cfg, batch, max_len, dev))
    else:
        cache = stackc(L.attention_cache(cfg, batch, max_len, dev))
    out = {"layers": cache,
           "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.shared_attn_every:
        out["shared"] = L.attention_cache(cfg, batch, max_len, dev)
    if cfg.enc_dec:
        out["enc_out"] = torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                     dtype=L.COMPUTE_DTYPE, device=dev)
    return out


def decode_step(cfg: ModelConfig, params, cache, token):
    """token: (B,) -> logits (B, vocab), updated cache (a new dict; the
    given one is not written)."""
    params = _params(params)
    x = _embed(params, token)[:, None]                    # (B,1,d)
    B = x.shape[0]
    pos = cache["pos"].expand(B, 1)
    shared = params.get("shared_attn")
    scache = cache.get("shared")
    new_layers = []
    for i in range(cfg.n_layers):
        p, lc = _index(params["layers"], i), _index(cache["layers"], i)
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        if cfg.ssm is not None:
            mix, lc = L.mamba2(cfg, p["mixer"], h, lc)
        elif cfg.mla is not None:
            mix, lc = L.mla_attention(cfg, p["mixer"], h, pos, lc)
        elif cfg.enc_dec:
            a, lc = L.attention(cfg, p["attn"], h, pos, lc)
            x = x + a
            h = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
            mix = _cross_attend(cfg, p["xattn"], h,
                                _enc_kv(p["xattn"], cache["enc_out"]))
        else:
            mix, lc = L.attention(cfg, p["mixer"], h, pos, lc)
        x = x + mix.to(x.dtype)
        if cfg.ssm is None:
            h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
            if cfg.moe is not None:
                f, _ = L.moe(cfg, p["ffn"], h)
            else:
                f = L.mlp(p["ffn"], h)
            x = x + f.to(x.dtype)
        if cfg.shared_attn_every and shared is not None \
                and i % cfg.shared_attn_every == 0:
            h = L.rmsnorm(shared["ln"], x, cfg.norm_eps)
            a, scache = L.attention(cfg, shared["attn"], h, pos, scache)
            x = x + a.to(x.dtype)
        new_layers.append(lc)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = _unembed(cfg, params, x)[:, 0]
    layers = {k: torch.stack([c[k] for c in new_layers])
              for k in new_layers[0]}
    new_cache = dict(cache, layers=layers, pos=cache["pos"] + 1)
    if scache is not None:
        new_cache["shared"] = scache
    return logits, new_cache
