"""PyTorch port, training (``repro_torch.train.train_step``) against the JAX
package for all ten architectures, on the smoke configs, on the CPU.

The reference's own parameter tree (``tests/torch_lm_ref.py``) is carried
into the port with ``params_from_jax``; both packages get the same numpy
batch (``host_batch_at``, equal in the two packages, plus the seeded
frontend embeddings of ``torch_lm_ref.inputs``).  Held: ``loss_fn``'s loss
and every gradient leaf against ``jax.value_and_grad`` in f32 compute and
in bf16, the ``_flash_sdpa`` path's gradient (threshold lowered in both
packages, causal and with a window), microbatching (against the port's
own half-batch gradients and the reference's ``lax.scan`` step),
rematerialization, and a 5-step ``make_train_step`` loss trajectory
against the reference's jitted step.

The reference's jitted step returns f64 parameters (its global x64 makes
the bias-corrected update f64); the trajectory rounds them to f32 between
steps, as the port keeps its parameters, and the tests never compare
dtypes.  One reference program per (architecture, dtype) computes the
step-0 gradient and every step of the trajectory, so JAX compiles twice
per architecture.

Tolerances.  In f32 compute the two packages differ only by the order of
f32 sums: the loss within ``F32_LOSS`` = 1e-5 and each gradient leaf
within ``F32_LEAF`` = 2e-5 of its largest magnitude (the largest seen is
3.8e-6, zamba2).  In bf16 (the default) the two frameworks round at other
places, and the backward pass compounds it: the loss within ``BF16_LOSS``
= 1e-3 (largest seen 1.5e-4), each gradient leaf's RMS difference within
``BF16_RMS`` = 2^-4 of its RMS (largest 0.037, the SSM archs) and its
largest difference within ``BF16_MAX`` = 2^-3 of its largest magnitude
(largest 0.064).  The trajectory's losses within ``TRAJ_LOSS`` = 5e-3.
"""

import contextlib
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_lm_ref as R  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, host_batch_at  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa
from repro_torch.train.pytree import tree_leaves  # noqa: E402

F32_LOSS, F32_LEAF = 1e-5, 2e-5
BF16_LOSS, BF16_RMS, BF16_MAX = 1e-3, 2.0 ** -4, 2.0 ** -3
TRAJ_LOSS = 5e-3
STEPS = 5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ALL = sorted(ARCHS)


@contextlib.contextmanager
def compute_dtype(f32):
    """Both packages' ``COMPUTE_DTYPE`` set to f32 when ``f32`` (the
    reference reads it while tracing)."""
    old = JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE
    if f32:
        JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE = old


def batch(arch, step):
    """The data pipeline's batch of ``step`` (2 x 16) as numpy, with the
    frontend embeddings where the architecture takes them."""
    cfg = smoke_config(arch)
    b = host_batch_at(DataConfig(cfg.vocab, R.B, R.S), step)
    fe = R.inputs(arch)[2]
    if fe is not None:
        b["frontend"] = fe
    return b


def port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def reference(arch, f32):
    """The reference's step 0 (loss, metrics, gradient leaves) and its
    STEPS-step jitted trajectory (losses), parameters rounded to f32
    between steps, all from one jitted program."""
    cfg = j_smoke_config(arch)
    opt_cfg, sc = JO.OptConfig(**OPT), JTS.StepConfig(remat=False)

    def step(params, opt, b):
        (loss, m), g = jax.value_and_grad(
            lambda p: JTS.loss_fn(cfg, sc, p, b["tokens"], b["labels"],
                                  b.get("frontend")), has_aux=True)(params)
        params, opt, om = JO.adamw_update(opt_cfg, params, g, opt)
        return loss, m, g, params, opt

    with compute_dtype(f32):
        fn = jax.jit(step)
        params = R.tree(arch)
        opt = JO.init_opt_state(params)
        losses = []
        for s in range(STEPS):
            loss, m, g, params, opt = fn(params, opt, batch(arch, s))
            params = jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float32), params)
            if s == 0:
                first = (float(loss), {k: float(v) for k, v in m.items()},
                         [np.asarray(x) for x in jax.tree_util.tree_leaves(g)])
            losses.append(float(loss))
    return first, losses


def port_grads(arch, f32, step_cfg=TS.StepConfig(remat=False), b=None):
    cfg = smoke_config(arch)
    params = params_from_jax(cfg, R.tree(arch), device="cpu")
    with compute_dtype(f32):
        loss, m, g = TS.loss_and_grads(cfg, step_cfg, params,
                                       port_batch(b or batch(arch, 0)))
    return float(loss), {k: float(v) for k, v in m.items()}, \
        [x.numpy() for x in tree_leaves(g)]


def assert_grads_close(got, want, f32):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        d = np.abs(a - b)
        top = max(float(np.abs(b).max()), 1e-30)
        if f32:
            assert d.max() <= F32_LEAF * top, (i, d.max(), top)
        else:
            rms = max(float(np.sqrt(np.mean(b * b))), 1e-30)
            assert np.sqrt(np.mean(d * d)) <= BF16_RMS * rms, (i, rms)
            assert d.max() <= BF16_MAX * top, (i, d.max(), top)


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_loss_and_gradients_match_reference(arch, f32):
    (jl, jm, jg), _ = reference(arch, f32)
    loss, m, g = port_grads(arch, f32)
    tol = F32_LOSS if f32 else BF16_LOSS
    assert abs(loss - jl) <= tol * abs(jl), (loss, jl)
    assert abs(m["nll"] - jm["nll"]) <= tol * abs(jm["nll"])
    assert abs(m["aux"] - jm["aux"]) <= tol * max(abs(jm["aux"]), 1.0)
    assert_grads_close(g, jg, f32)


@pytest.mark.parametrize("arch", ALL)
def test_trajectory_matches_reference(arch):
    """STEPS steps of ``make_train_step`` (bf16, AdamW) on the data
    pipeline's batches: the losses follow the reference's jitted step."""
    cfg = smoke_config(arch)
    _, want = reference(arch, False)
    params = params_from_jax(cfg, R.tree(arch), device="cpu")
    opt = init_opt_state(params)
    step = TS.make_train_step(cfg, OptConfig(**OPT),
                              TS.StepConfig(remat=False))
    got = []
    for s in range(STEPS):
        params, opt, m = step(params, opt, port_batch(batch(arch, s)))
        got.append(float(m["loss"]))
    assert int(opt.step) == STEPS
    np.testing.assert_allclose(got, want, rtol=TRAJ_LOSS)


@pytest.mark.parametrize("arch", ALL)
def test_microbatches_average_half_batches(arch):
    """microbatches=2: the gradient is the mean of the two half-batch
    gradients (summed in f32, halved), the loss their mean, nll and aux the
    second half's; without MoE (whose capacity and aux depend on the
    tokens routed together) it is the full batch's gradient too."""
    b = batch(arch, 0)
    halves = [{k: v[i:i + 1] for k, v in b.items()} for i in range(2)]
    parts = [port_grads(arch, True, b=h) for h in halves]
    loss, m, g = port_grads(arch, True, TS.StepConfig(microbatches=2,
                                                      remat=False))
    assert loss == np.float32(parts[0][0] + parts[1][0]) / np.float32(2)
    assert m == parts[1][1]
    for a, x, y in zip(g, parts[0][2], parts[1][2]):
        np.testing.assert_array_equal(a, (x + y) / np.float32(2))
    if smoke_config(arch).moe is None:
        full = port_grads(arch, True)
        assert abs(loss - full[0]) <= F32_LOSS * abs(full[0])
        assert_grads_close(g, full[2], True)


@pytest.mark.parametrize("arch", ALL)
def test_remat_gradient_equals_plain(arch):
    """Per-block rematerialization recomputes the same ops: the same loss
    and gradient bit for bit on the CPU."""
    loss, m, g = port_grads(arch, False, TS.StepConfig(remat=True))
    want = port_grads(arch, False)
    assert (loss, m) == want[:2]
    for a, b in zip(g, want[2]):
        np.testing.assert_array_equal(a, b)


def test_microbatch_step_matches_reference_scan():
    """The reference's ``lax.scan`` accumulation (microbatches=2), f32
    compute: loss (the mean), nll and aux (the last microbatch), the norm
    of the averaged gradient and the learning rate."""
    arch = "minitron-4b"
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    b = batch(arch, 0)
    with compute_dtype(True):
        jstep = jax.jit(JTS.make_train_step(
            jcfg, JO.OptConfig(**OPT), JTS.StepConfig(microbatches=2,
                                                      remat=False)))
        tree = R.tree(arch)
        _, _, jm = jstep(tree, JO.init_opt_state(tree), b)
        params = params_from_jax(cfg, tree, device="cpu")
        step = TS.make_train_step(cfg, OptConfig(**OPT), TS.StepConfig(
            microbatches=2, remat=False))
        _, _, m = step(params, init_opt_state(params), port_batch(b))
    for k in ("loss", "nll", "aux", "gnorm", "lr"):
        assert abs(float(m[k]) - float(jm[k])) <= \
            F32_LOSS * max(abs(float(jm[k])), 1e-3), k


@pytest.mark.parametrize("arch,window", [("minitron-4b", None),
                                         ("h2o-danube-3-4b", 8),
                                         ("minicpm3-4b", None)])
def test_flash_sdpa_gradient(arch, window, monkeypatch):
    """``_flash_sdpa``'s backward (the reference differentiates its scan):
    the threshold and chunks lowered in both packages so that S = 16 takes
    the chunked path (4 q-chunks of 4 x 2 kv-chunks of 8, causal triangle
    skipped, sliding window where the config has one), f32 compute."""
    assert smoke_config(arch).window == window
    for mod in (JL, L):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 8)
        monkeypatch.setattr(mod, "FLASH_QC", 4)
        monkeypatch.setattr(mod, "FLASH_KC", 8)
    cfg = j_smoke_config(arch)
    b = batch(arch, 0)
    with compute_dtype(True):
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: JTS.loss_fn(cfg, JTS.StepConfig(remat=False), p,
                                  b["tokens"], b["labels"]),
            has_aux=True))(R.tree(arch))
    calls = []
    flash = L._flash_sdpa
    monkeypatch.setattr(L, "_flash_sdpa",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    loss, _, g = port_grads(arch, True)
    assert len(calls) == smoke_config(arch).n_layers
    assert abs(loss - float(jl)) <= F32_LOSS * abs(float(jl))
    assert_grads_close(g, [np.asarray(x) for x in
                           jax.tree_util.tree_leaves(jg)], True)
    assert all(np.isfinite(x).all() for x in g)
