"""PyTorch port, LM layers (``repro_torch.models.layers``) against the JAX
package's ``repro.models.layers`` on identical seeded numpy inputs and
parameters, on the CPU (the reference jitted, as its own tests run it).

Tolerances, by what the layer computes in:

- f32 algorithms (``apply_rope`` and ``_sdpa`` on f32 inputs, the online
  softmax of ``_flash_sdpa`` against the reference's, ``ssd_chunked``):
  the same operations in another order, so ``F32`` (rtol = atol = 1e-5,
  ``SSD`` 1e-4 for the 4-operand einsums over a chunk);
- flash against materialized attention: the reference's own 2e-3
  (tests/test_attention.py);
- bf16 layers: a few bf16 ulps (XLA keeps f32 inside fused elementwise
  chains, torch rounds after each op): ``BF16`` = 2^-5 of the largest
  magnitude of the output (8 ulps of its largest entry);
- absorbed against naive MLA: the reference's rtol 0.08, atol 0.02
  (tests/test_attention.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import layers as JL
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L

F32 = dict(rtol=1e-5, atol=1e-5)
SSD = dict(rtol=1e-4, atol=1e-4)
FLASH = dict(rtol=2e-3, atol=2e-3)
BF16 = 2.0 ** -5


def rng(seed):
    return np.random.default_rng(seed)


def bf16_exact(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def rand_params(meta, r, scale=0.1):
    """f32 numpy params for a layer meta: normal * scale, ones / zeros
    perturbed by the same noise (so norms and biases do something)."""
    out = {}
    for k, pm in meta.items():
        if isinstance(pm, dict):
            out[k] = rand_params(pm, r, scale)
            continue
        noise = (r.standard_normal(pm.shape) * scale).astype(np.float32)
        out[k] = noise + np.float32(pm.init == "ones")
    return out


def t_tree(tree):
    return {k: t_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def assert_close_bf16(got, want, what=""):
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = BF16 * max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)


def assert_same(got, want, what="", **tol):
    """Same shape and dtype, values within ``tol`` (bf16 rule if none)."""
    assert dtype_name(got) == str(want.dtype), (what, got.dtype, want.dtype)
    if tol:
        np.testing.assert_allclose(to_np(got), to_np(want), err_msg=what,
                                   **tol)
    else:
        assert_close_bf16(got, want, what)


def assert_cache_same(got, want, what=""):
    assert sorted(got) == sorted(want)
    for k in want:
        if str(want[k].dtype).startswith("int"):
            assert dtype_name(got[k]) == str(want[k].dtype)
            np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]))
        else:
            assert_same(got[k], want[k], f"{what} {k}")


def bf16_pair(a):
    """The same bf16 values for both packages."""
    a = bf16_exact(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


# --------------------------------------------------------------------------
# norms / rope / materialized attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    r = rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    if dtype == "bfloat16":
        jx, tx = bf16_pair(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = JL.rmsnorm({"scale": scale}, jx, 1e-5)
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5)
    # f32 x times the bf16 scale is f32; bf16 x gives bf16
    assert_same(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_interleaved(dtype):
    r = rng(1)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    if dtype == "bfloat16":
        jx, tx = bf16_pair(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10000.0)
    got = L.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    if dtype == "bfloat16":
        assert_same(got, want)
    else:
        assert_same(got, want, **F32)
    # adjacent pairs rotate together: position 0 is the identity, and at
    # any position the norm of each (x0, x1) pair is kept
    np.testing.assert_allclose(to_np(got)[0, 0], to_np(tx)[0, 0], **F32)
    g = to_np(got).reshape(2, 7, 3, 8, 2)
    xs = to_np(tx).reshape(2, 7, 3, 8, 2)
    np.testing.assert_allclose(np.hypot(g[..., 0], g[..., 1]),
                               np.hypot(xs[..., 0], xs[..., 1]),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5)


def _qkv(B, S, T, H, Kv, hd, dv=None, seed=0):
    r = rng(seed)
    return (r.standard_normal((B, S, H, hd)).astype(np.float32),
            r.standard_normal((B, T, Kv, hd)).astype(np.float32),
            r.standard_normal((B, T, Kv, dv or hd)).astype(np.float32))


def _causal(S, T, window=None):
    m = np.arange(S)[:, None] >= np.arange(T)[None, :]
    if window is not None:
        m &= (np.arange(S)[:, None] - np.arange(T)[None, :]) < window
    return m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_materialized(dtype):
    q, k, v = _qkv(2, 9, 9, 4, 2, 16, seed=2)
    mask = _causal(9, 9)[None, None, None]
    if dtype == "bfloat16":
        (jq, tq), (jk, tk), (jv, tv) = map(bf16_pair, (q, k, v))
    else:
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = JL._sdpa(jq, jk, jv, jnp.asarray(mask))
    got = L._sdpa(tq, tk, tv, torch.from_numpy(mask))
    if dtype == "bfloat16":
        assert_same(got, want)
    else:
        assert_same(got, want, **F32)


# --------------------------------------------------------------------------
# flash (online-softmax) attention: the reference's cases
# --------------------------------------------------------------------------

FLASH_CASES = [
    # (B, S, T, H, Kv, hd, dv, causal, window, qc, kc, seed)
    (2, 256, 256, 4, 2, 32, None, True, None, 64, 128, 0),
    (2, 384, 384, 4, 2, 32, None, True, None, 64, 128, 0),
    (2, 256, 256, 4, 2, 32, None, False, None, 64, 128, 0),
    (2, 384, 384, 4, 2, 32, None, False, None, 64, 128, 0),
    (2, 256, 512, 4, 2, 32, None, False, None, 64, 128, 0),
    (1, 512, 512, 4, 4, 16, None, True, 64, 64, 64, 3),     # window
    (2, 320, 320, 4, 4, 24, 8, True, None, 64, 64, 4),      # asymmetric v
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"S{c[1]}T{c[2]}c{int(c[7])}"
                         f"w{c[8]}dv{c[6]}")
def test_flash_sdpa(case):
    B, S, T, H, Kv, hd, dv, causal, window, qc, kc, seed = case
    q, k, v = _qkv(B, S, T, H, Kv, hd, dv, seed)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = L._flash_sdpa(tq, tk, tv, causal, window=window, qc=qc, kc=kc)
    want = jax.jit(lambda *z: JL._flash_sdpa(
        *z, causal, window=window, qc=qc, kc=kc))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # the same online softmax as the reference's, in f32
    assert_same(got, want, **F32)
    # and the materialized attention, at the reference's own tolerance
    m = _causal(S, T, window) if causal else np.ones((S, T), bool)
    ref = L._sdpa(tq, tk, tv, torch.from_numpy(m)[None, None, None])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **FLASH)


def test_sdpa_dispatches_long_sequences_to_flash():
    """Above FLASH_THRESHOLD (and without a mask) sdpa is the chunked
    path, with the default chunks: bf16 rows padded to whole chunks."""
    S = L.FLASH_THRESHOLD + 100
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, S, S, 2, 1, 16, seed=5))
    got = L.sdpa(q, k, v, causal=True)
    assert torch.equal(got, L._flash_sdpa(q, k, v, True))
    m = torch.from_numpy(_causal(S, S))[None, None, None]
    np.testing.assert_allclose(got.float().numpy(),
                               L._sdpa(q, k, v, m).float().numpy(),
                               rtol=0, atol=2 ** -6)


# --------------------------------------------------------------------------
# attention with and without a cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b",
                                  "h2o-danube-3-4b"])
def test_attention_prefill_and_decode(arch):
    """GQA prefill, then 12 decode steps into a cache of max_len 12: for
    h2o-danube (window 8) a ring of 8 slots that wraps at step 9."""
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    r = rng(6)
    params = rand_params(L.attention_meta(cfg), r)
    tp = t_tree(params)
    x = r.standard_normal((2, 12, cfg.d_model)) * 2
    jx, tx = bf16_pair(x)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want, _ = jax.jit(lambda p, x, pos: JL.attention(jcfg, p, x, pos))(
        params, jx, jnp.asarray(pos))
    got, none = L.attention(cfg, tp, tx, torch.from_numpy(pos))
    assert none is None
    assert_same(got, want, "prefill")

    step = jax.jit(lambda p, x, pos, c: JL.attention(jcfg, p, x, pos, c))
    jc = JL.attention_cache(jcfg, 2, 12)
    tc = L.attention_cache(cfg, 2, 12, device="cpu")
    assert tuple(tc["k"].shape) == jc["k"].shape
    for i in range(12):
        wo, jc = step(params, jx[:, i:i + 1], jnp.asarray(pos[:, i:i + 1]),
                      jc)
        go, tc = L.attention(cfg, tp, tx[:, i:i + 1],
                             torch.from_numpy(pos[:, i:i + 1]), tc)
        assert_same(go, wo, f"step {i}")
        assert_cache_same(tc, jc, f"step {i}")
    assert int(tc["idx"]) == 12
    if cfg.window is not None:
        assert tc["k"].shape[1] == cfg.window == 8
        # decode over a ring equals the windowed prefill at the last token
        assert_close_bf16(go[:, 0], got[:, -1], "ring vs window")


def test_attention_slot_past_the_end_is_clamped():
    """A full (non-window) cache written once more: the write lands in the
    last slot and the mask covers every slot, as XLA's clamp does."""
    arch = "minitron-4b"
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    r = rng(7)
    params = rand_params(L.attention_meta(cfg), r)
    jx, tx = bf16_pair(r.standard_normal((2, 1, cfg.d_model)))
    pos = np.full((2, 1), 5, np.int32)
    jc = dict(JL.attention_cache(jcfg, 2, 4), idx=jnp.int32(6))
    tc = dict(L.attention_cache(cfg, 2, 4, device="cpu"),
              idx=torch.tensor(6, dtype=torch.int32))
    wo, jc = jax.jit(lambda p, x, pos, c: JL.attention(jcfg, p, x, pos, c))(
        params, jx, jnp.asarray(pos), jc)
    go, tc = L.attention(cfg, t_tree(params), tx, torch.from_numpy(pos), tc)
    assert_same(go, wo)
    assert_cache_same(tc, jc)
    assert bool(tc["k"][:, -1].any()) and not bool(tc["k"][:, :-1].any())


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def test_mla_prefill_decode_and_absorbed():
    arch = "minicpm3-4b"
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    r = rng(8)
    params = rand_params(L.mla_meta(cfg), r)
    tp = t_tree(params)
    x = r.standard_normal((2, 6, cfg.d_model)) * 2
    jx, tx = bf16_pair(x)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    want, _ = jax.jit(lambda p, x, pos: JL.mla_attention(jcfg, p, x, pos))(
        params, jx, jnp.asarray(pos))
    got, _ = L.mla_attention(cfg, tp, tx, torch.from_numpy(pos))
    assert_same(got, want, "prefill")

    step = jax.jit(lambda p, x, pos, c: JL.mla_attention(jcfg, p, x, pos, c))
    jc = JL.mla_cache(jcfg, 2, 8)
    tc = L.mla_cache(cfg, 2, 8, device="cpu")
    ac = tc
    for i in range(6):
        sl = slice(i, i + 1)
        wo, jc = step(params, jx[:, sl], jnp.asarray(pos[:, sl]), jc)
        go, tc = L.mla_attention(cfg, tp, tx[:, sl],
                                 torch.from_numpy(pos[:, sl]), tc)
        ao, ac = L.mla_attention_absorbed(cfg, tp, tx[:, sl],
                                          torch.from_numpy(pos[:, sl]), ac)
        assert_same(go, wo, f"naive step {i}")
        assert_cache_same(tc, jc, f"step {i}")
        # absorbed == naive at the reference's tolerance; same latent cache
        np.testing.assert_allclose(to_np(ao), to_np(go), rtol=0.08,
                                   atol=0.02)
        assert torch.equal(ac["c"], tc["c"]) and torch.equal(ac["r"],
                                                               tc["r"])
    # the module flag routes decode through the absorbed form
    old = L.MLA_ABSORBED_DECODE
    try:
        L.MLA_ABSORBED_DECODE = True
        fo, _ = L.mla_attention(cfg, tp, tx[:, :1],
                                torch.from_numpy(pos[:, :1]),
                                L.mla_cache(cfg, 2, 8, device="cpu"))
    finally:
        L.MLA_ABSORBED_DECODE = old
    ao, _ = L.mla_attention_absorbed(cfg, tp, tx[:, :1],
                                     torch.from_numpy(pos[:, :1]),
                                     L.mla_cache(cfg, 2, 8, device="cpu"))
    assert torch.equal(fo, ao)


# --------------------------------------------------------------------------
# MLP / MoE
# --------------------------------------------------------------------------

def test_mlp():
    cfg = smoke_config("minitron-4b")
    r = rng(9)
    params = rand_params(L.mlp_meta(cfg), r)
    jx, tx = bf16_pair(r.standard_normal((2, 5, cfg.d_model)))
    assert_same(L.mlp(t_tree(params), tx), jax.jit(JL.mlp)(params, jx))


@pytest.mark.parametrize("arch,S", [("moonshot-v1-16b-a3b", 16),
                                    ("moonshot-v1-16b-a3b", 1),
                                    ("dbrx-132b", 16)])
def test_moe_dispatch(arch, S):
    """Sort-based capacity dispatch: outputs and aux equal the reference's,
    with assignments dropped past capacity (cap recomputed at S=1)."""
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    r = rng(10)
    params = rand_params(L.moe_meta(cfg), r, scale=0.3)
    # a direction every token shares, which the router reads as expert 0:
    # expert 0 is over capacity
    common = r.standard_normal(cfg.d_model)
    params["router"][:, 0] += (0.2 * common).astype(np.float32)
    jx, tx = bf16_pair(r.standard_normal((3, S, cfg.d_model)) + common)
    want, waux = jax.jit(lambda p, x: JL.moe(jcfg, p, x))(params, jx)
    got, aux = L.moe(cfg, t_tree(params), tx)
    assert_same(got, want)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(waux), rel=1e-4)
    # the case drops assignments: some expert got more than its capacity
    mo = cfg.moe
    cap = int(np.ceil(mo.capacity_factor * 3 * S * mo.top_k / mo.n_experts))
    logits = torch.einsum("bsd,de->bse", tx.float(), L.cast(
        t_tree(params)["router"]).float())
    counts = torch.bincount(torch.topk(logits, mo.top_k).indices.reshape(-1),
                            minlength=mo.n_experts)
    assert int(counts.max()) > cap


# --------------------------------------------------------------------------
# Mamba-2 (SSD)
# --------------------------------------------------------------------------

def _ssd_inputs(b, l, h, p, n, seed, bf16=True):
    r = rng(seed)
    x = r.standard_normal((b, l, h, p))
    a = -np.abs(r.standard_normal((b, l, h))).astype(np.float32) * 0.5
    B = r.standard_normal((b, l, n))
    C = r.standard_normal((b, l, n))
    conv = bf16_exact if bf16 else (lambda z: z.astype(np.float32))
    return conv(x), a, conv(B), conv(C)


def _recurrence(x, a, B, C):
    """The SSM run token by token: h_t = exp(a_t) h_{t-1} + x_t B_t^T,
    y_t = h_t C_t (f32)."""
    b, l, h, p = x.shape
    st = torch.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(l):
        st = st * torch.exp(a[:, t])[..., None, None] \
            + x[:, t, :, :, None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", st, C[:, t]))
    return torch.stack(ys, dim=1)


def test_ssd_chunked_matches_reference_and_recurrence():
    x, a, B, C = _ssd_inputs(2, 32, 3, 4, 8, seed=11)
    want = jax.jit(lambda *z: JL.ssd_chunked(*z, 8))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
        jnp.asarray(B, jnp.bfloat16), jnp.asarray(C, jnp.bfloat16))
    tx, tB, tC = (torch.from_numpy(z).bfloat16() for z in (x, B, C))
    got = L.ssd_chunked(tx, torch.from_numpy(a), tB, tC, 8)
    # bf16 x, B, C with f32 decays compute in f32, as jnp.einsum promotes
    assert_same(got, want, **SSD)
    # the chunked scan is the recurrence, over 4 chunks and over 1
    fx, fa, fB, fC = (torch.from_numpy(z) for z in _ssd_inputs(
        2, 32, 3, 4, 8, seed=12, bf16=False))
    rec = _recurrence(fx, fa, fB, fC)
    for chunk in (8, 32):
        np.testing.assert_allclose(
            L.ssd_chunked(fx, fa, fB, fC, chunk).numpy(), rec.numpy(), **SSD)
    with pytest.raises(ValueError, match="multiple"):
        L.ssd_chunked(fx, fa, fB, fC, 6)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_mamba2_both_modes(arch):
    """Prefill (chunked SSD over 2 chunks) and 4 decode steps from
    mamba2_cache: outputs and caches equal the reference's; the state
    turns f32 at the first step; decode reproduces the prefill."""
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    r = rng(13)
    params = rand_params(L.mamba2_meta(cfg), r)
    tp = t_tree(params)
    jx, tx = bf16_pair(r.standard_normal((2, 16, cfg.d_model)) * 2)
    want, _ = jax.jit(lambda p, x: JL.mamba2(jcfg, p, x))(params, jx)
    got, none = L.mamba2(cfg, tp, tx)
    assert none is None and got.dtype == torch.float32
    assert_same(got, want, "prefill")

    step = jax.jit(lambda p, x, c: JL.mamba2(jcfg, p, x, c))
    jc = JL.mamba2_cache(jcfg, 2)
    tc = L.mamba2_cache(cfg, 2, device="cpu")
    assert tc["state"].dtype == torch.bfloat16
    outs = []
    for i in range(4):
        wo, jc = step(params, jx[:, i:i + 1], jc)
        go, tc = L.mamba2(cfg, tp, tx[:, i:i + 1], tc)
        assert_same(go, wo, f"step {i}")
        assert_cache_same(tc, jc, f"step {i}")
        outs.append(go)
    assert tc["state"].dtype == torch.float32
    assert_close_bf16(torch.cat(outs, 1), got[:, :4], "decode vs prefill")
