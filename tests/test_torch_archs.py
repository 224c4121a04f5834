"""PyTorch port, LM stacks (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package for all ten architectures.

The reference's own parameter tree (``init_params``, then ``np.asarray``)
is carried into the port with ``params_from_jax``; both packages get the
same seeded numpy inputs (``tests/torch_lm_ref.py``).  Held: the configs
and their tables, ``lm_meta`` / ``abstract_params`` / ``init_cache``
shapes and dtypes, the carry-across byte for byte, ``lm_apply`` logits
and aux, and two ``decode_step``s (logits and every cache leaf, dtype
included) on the smoke configs, on the CPU.

Tolerances.  bf16 rounds at other places in the two frameworks (XLA
fuses elementwise chains and keeps f32 between their ops; torch rounds
after each), so values agree to a few bf16 ulps, not bit for bit.  Smoke
logits are below 0.7 in magnitude, where a bf16 ulp is 2^-8 to 2^-9;
the largest difference seen is 0.0088, so ``LOGIT_ATOL`` = 0.03 (about 8
ulps).  Cache leaves: within ``LEAF_TOL`` = 2^-5 of the leaf's largest
magnitude (8 ulps of its largest entry), and the same dtype and shape.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_lm_ref as R  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        params_to_numpy)

LOGIT_ATOL = 0.03
LEAF_TOL = 2.0 ** -5
ALL = sorted(ARCHS)


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return params_from_jax(smoke_config(arch), R.tree(arch), device="cpu")


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict, keys sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def as_np(t):
    """(float32 or int numpy array, dtype name) of a tensor or an array."""
    if isinstance(t, torch.Tensor):
        name = str(t.dtype).replace("torch.", "")
        return (t.float() if t.is_floating_point() else t).numpy(), name
    a = np.asarray(t)
    return (a.astype(np.float32) if a.dtype.kind == "V" or
            str(a.dtype) == "bfloat16" else a), str(a.dtype)


def assert_leaves_close(got_tree, want_tree, what):
    got, want = leaves(got_tree), leaves(want_tree)
    assert sorted(got) == sorted(want), what
    for k in want:
        g, gd = as_np(got[k])
        w, wd = as_np(want[k])
        assert gd == wd and g.shape == w.shape, (what, k, gd, wd, g.shape,
                                                 w.shape)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            tol = LEAF_TOL * max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                       err_msg=f"{what} {k}")


def port_decode(arch, n):
    """The port's ``decode_step`` over the first ``n`` tokens the
    reference fed: (logits list, caches after every step)."""
    cfg = smoke_config(arch)
    params = port_params(arch)
    fed = R.decoded(arch)[0]
    _, _, frontend = R.inputs(arch)
    with torch.no_grad():
        cache = T.init_cache(cfg, R.B, R.MAX_LEN, device="cpu")
        if cfg.enc_dec:
            cache = dict(cache, enc_out=T._encoder_apply(
                cfg, params, torch.from_numpy(frontend)).to(torch.bfloat16))
        logits, caches = [], []
        for t in fed[:n]:
            lg, cache = T.decode_step(cfg, params, cache,
                                      torch.from_numpy(t))
            logits.append(lg.numpy())
            caches.append(cache)
    return logits, caches


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_archs_and_shapes_equal_reference():
    assert ARCHS == J_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_registry.SHAPES.items()}


@pytest.mark.parametrize("arch", ALL)
def test_configs_equal_reference(arch):
    for mine, ref in ((get_config(arch), j_get_config(arch)),
                      (smoke_config(arch), j_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        assert (mine.hd, mine.vocab_padded) == (ref.hd, ref.vocab_padded)
    for name, shape in SHAPES.items():
        cfg = get_config(arch)
        assert registry.shape_applicable(cfg, shape) == \
            j_registry.shape_applicable(j_get_config(arch),
                                        j_registry.SHAPES[name])
        got = registry.input_specs(cfg, shape)
        want = j_registry.input_specs(j_get_config(arch),
                                      j_registry.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)


@pytest.mark.parametrize("arch", ALL)
def test_exact_assigned_config(arch):
    """The full config matches the assigned architecture table exactly
    (tests/test_archs.py's table, against the port's configs)."""
    cfg = get_config(arch)
    table = {
        "mamba2-2.7b": (64, 2560, None, None, 0, 50280),
        "whisper-medium": (24, 1024, 16, 16, 4096, 51865),
        "minitron-4b": (32, 3072, 24, 8, 9216, 256000),
        "qwen2.5-32b": (64, 5120, 40, 8, 27648, 152064),
        "h2o-danube-3-4b": (24, 3840, 32, 8, 10240, 32000),
        "minicpm3-4b": (62, 2560, 40, 40, 6400, 73448),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "zamba2-7b": (81, 3584, 32, 32, 14336, 32000),
        "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
    }
    L_, d, H, Kv, ff, V = table[arch]
    assert cfg.n_layers == L_ and cfg.d_model == d and cfg.d_ff == ff \
        and cfg.vocab == V
    if H is not None:
        assert cfg.n_heads == H and cfg.n_kv == Kv
    if arch == "mamba2-2.7b":
        assert cfg.ssm.d_state == 128
    if arch == "zamba2-7b":
        assert cfg.ssm.d_state == 64 and cfg.shared_attn_every
    if arch == "dbrx-132b":
        assert cfg.moe.n_experts == 16 and cfg.moe.top_k == 4
    if arch == "moonshot-v1-16b-a3b":
        assert cfg.moe.n_experts == 64 and cfg.moe.top_k == 6
    if arch == "minicpm3-4b":
        assert cfg.mla is not None
    if arch == "h2o-danube-3-4b":
        assert cfg.window == 4096
    if arch == "qwen2.5-32b":
        assert cfg.qkv_bias


def test_param_counts_plausible():
    expect = {"mamba2-2.7b": (2e9, 4e9), "qwen2.5-32b": (25e9, 40e9),
              "dbrx-132b": (100e9, 160e9), "minitron-4b": (3e9, 6.5e9),
              "moonshot-v1-16b-a3b": (12e9, 30e9),
              "internvl2-1b": (0.4e9, 1.3e9)}
    for arch, (lo, hi) in expect.items():
        n = get_config(arch).param_count()
        assert lo < n < hi, f"{arch}: {n/1e9:.2f}B params out of range"


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _pm_leaves(meta):
    return {k: (v.shape, v.axes, v.init) for k, v in leaves(meta).items()}


@pytest.mark.parametrize("arch", ALL)
def test_lm_meta_and_abstract_params(arch):
    """The meta trees are equal (shape, logical axes, init) for the full
    and smoke configs; ``abstract_params`` is ``meta`` f32 of those
    shapes."""
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (smoke_config(arch), j_smoke_config(arch))):
        mine = _pm_leaves(T.lm_meta(cfg))
        assert mine == _pm_leaves(JT.lm_meta(jcfg))
        abstract = leaves(T.abstract_params(cfg))
        assert sorted(abstract) == sorted(mine)
        for k, t in abstract.items():
            assert t.device.type == "meta" and t.dtype == torch.float32
            assert tuple(t.shape) == mine[k][0]


@pytest.mark.parametrize("arch", ALL)
def test_params_carry_across_byte_equal(arch):
    """params_from_jax -> params_to_numpy returns the reference's tree
    byte for byte; the module's state_dict names mirror the tree."""
    cfg = smoke_config(arch)
    ref = leaves(R.tree(arch))
    module = port_params(arch)
    back = leaves(params_to_numpy(module))
    assert sorted(back) == sorted(ref)
    for k, a in ref.items():
        assert back[k].dtype == np.float32 and back[k].tobytes() == \
            a.tobytes(), k
    assert sorted(module.state_dict()) == sorted(
        k.replace("/", ".") for k in ref)
    assert sum(t.numel() for t in module.parameters()) == sum(
        a.size for a in ref.values())
    # the module is a copy: writing the numpy tree changes nothing
    again = params_from_jax(cfg, params_to_numpy(module), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(again.parameters(), module.parameters()))


def test_params_from_jax_rejects_a_wrong_tree():
    cfg = smoke_config("minitron-4b")
    tree = params_to_numpy(port_params("minitron-4b"))
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(cfg, bad, device="cpu")
    bad = dict(tree, ln_f={"scale": tree["ln_f"]["scale"].astype(
        np.float64)})
    with pytest.raises(ValueError, match="ln_f/scale"):
        params_from_jax(cfg, bad, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "unembed"}
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(cfg, bad, device="cpu")


def test_init_params_seeded():
    """Seeded parameters: the same seed (or an equal generator) gives the
    same tree, shaped as lm_meta, ones/zeros where the meta says so."""
    cfg = smoke_config("zamba2-7b")
    a = T.init_params(cfg, 3, device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = T.init_params(cfg, 4, device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    meta = _pm_leaves(T.lm_meta(cfg))
    for k, t in leaves(a.tree()).items():
        shape, _, init = meta[k]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        if init == "ones":
            assert bool((t == 1).all())
        elif init == "zeros":
            assert bool((t == 0).all())
        else:
            assert 0.01 < float(t.detach().std()) < 0.03
    with pytest.raises(ValueError, match="generator"):
        T.init_params(cfg, torch.Generator(), device="meta")


# --------------------------------------------------------------------------
# forward and decode against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_lm_apply_matches_reference(arch):
    cfg = smoke_config(arch)
    tokens, _, frontend = R.inputs(arch)
    want, want_aux = R.forward(arch)
    with torch.no_grad():
        fe = None if frontend is None else torch.from_numpy(frontend)
        got, aux = T.lm_apply(cfg, port_params(arch),
                              torch.from_numpy(tokens), fe)
    S_out = R.S + (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    assert got.shape == (R.B, S_out, cfg.vocab_padded) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    # MoE load-balancing aux: f32 sums over the same routing
    assert float(aux) == pytest.approx(want_aux, rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("arch", ALL)
def test_decode_steps_match_reference(arch):
    """Two decode steps from a fresh cache: logits, and every cache leaf
    with its dtype (the SSM state is bf16 in init_cache and f32 from the
    first step on; the second step runs on the promoted state)."""
    _, want_logits, want_caches = R.decoded(arch)
    logits, caches = port_decode(arch, 2)
    for i in range(2):
        np.testing.assert_allclose(logits[i], want_logits[i], rtol=0,
                                   atol=LOGIT_ATOL)
        assert_leaves_close(caches[i], want_caches[i], f"step {i + 1}")
    assert int(caches[1]["pos"]) == 2
    if smoke_config(arch).ssm is not None:
        assert caches[0]["layers"]["state"].dtype == torch.float32


@pytest.mark.parametrize("arch", ALL)
def test_init_cache_matches_reference(arch):
    cfg = smoke_config(arch)
    got = leaves(T.init_cache(cfg, 3, 7, device="cpu"))
    want = leaves(JT.init_cache(j_smoke_config(arch), 3, 7))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        g, gd = as_np(t)
        w, wd = as_np(want[k])
        assert (g.shape, gd) == (w.shape, wd), k
        assert not g.any()


@pytest.mark.parametrize("arch", ["minitron-4b", "whisper-medium"])
def test_lm_apply_remat_same_values_and_grads(arch):
    """remat=True checkpoints each block: the same logits, aux and
    parameter gradients as without it."""
    cfg = smoke_config(arch)
    tokens, _, frontend = R.inputs(arch)
    fe = None if frontend is None else torch.from_numpy(frontend)
    out = []
    for remat in (False, True):
        params = params_from_jax(cfg, R.tree(arch), device="cpu")
        logits, aux = T.lm_apply(cfg, params, torch.from_numpy(tokens), fe,
                                 remat=remat)
        (logits[..., :cfg.vocab].float().pow(2).mean() + aux).backward()
        out.append((logits.detach(), [p.grad for p in params.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
