"""PyTorch port, LM serving: ``repro_torch.serve.generate`` against the
JAX package's ``repro.serve.generate`` for all ten architectures on the
smoke configs, on the CPU, from the reference's own parameter tree
carried across with ``params_from_jax`` (``tests/torch_lm_ref.py``).

Greedy tokens: random smoke models have flat logits, so the top two are
often close; a near tie may break either way between the packages,
whose logits differ by a few bf16 ulps.  So the port's tokens must equal
the reference's at every step up to the first step where they differ,
and every row that differs there must be at a near tie: the reference's
top-1/top-2 margin in that row at most ``MARGIN_TOL``.  ``MARGIN_TOL`` is twice ``LOGIT_ATOL``
(0.03, tests/test_torch_archs.py), because the port's logits along the
reference's tokens are held within ``LOGIT_ATOL`` of the reference's at
every step (teacher forcing, below): a margin above it cannot flip.  The
number of steps compared is recorded per architecture
(``steps_compared``) and printed.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_lm_ref as R  # noqa: E402
from test_torch_archs import (LOGIT_ATOL, assert_leaves_close,  # noqa: E402
                              port_decode, port_params)

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.serve.engine import prefill  # noqa: E402

MARGIN_TOL = 2 * LOGIT_ATOL
ALL = sorted(ARCHS)
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def port_generate(arch, **kw):
    _, prompts, frontend = R.inputs(arch)
    fe = None if frontend is None else torch.from_numpy(frontend)
    return generate(smoke_config(arch), port_params(arch), prompts,
                    R.STEPS, frontend=fe, device="cpu", **kw)


def reference_margins(arch):
    """Top-1 minus top-2 of the reference's logits at each generated
    step, for each row of the batch: (STEPS, B)."""
    logits = R.decoded(arch)[1][R.P - 1:]               # (STEPS, B, V)
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("arch", ALL)
def test_greedy_tokens_match_reference(arch, record_property):
    got = port_generate(arch)
    want = R.generated(arch)
    assert got.shape == want.shape == (R.B, R.STEPS)
    assert got.dtype == np.int32
    differs = np.flatnonzero((got != want).any(axis=0))
    compared = int(differs[0]) if len(differs) else R.STEPS
    record_property("steps_compared", compared)
    print(f"{arch}: {compared} of {R.STEPS} steps equal")
    if compared < R.STEPS:
        rows = got[:, compared] != want[:, compared]
        margin = reference_margins(arch)[compared][rows].max()
        assert margin <= MARGIN_TOL, (
            f"{arch}: tokens differ at step {compared} in rows "
            f"{np.flatnonzero(rows)}, where the reference's top-2 margin "
            f"reaches {margin:.4f} > {MARGIN_TOL}")


@pytest.mark.parametrize("arch", ALL)
def test_logits_along_reference_tokens(arch):
    """Teacher forcing: the port's decode_step fed the prompt and the
    reference's generated tokens gives the reference's logits at every
    step, and the final caches agree leaf for leaf (for zamba2 the shared
    cache has overrun max_len by then, see below)."""
    fed, want_logits, want_caches = R.decoded(arch)
    logits, caches = port_decode(arch, len(fed))
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {i}")
    assert_leaves_close(caches[-1], want_caches[-1], "last step")


def test_zamba2_shared_cache_overruns_like_the_reference():
    """zamba2-smoke (shared attention every 2nd of 4 layers) writes its one
    shared cache twice per token, so P=3, steps=8 makes 20 writes into a
    cache of MAX_LEN=12: XLA clamps the slot to the last one and the mask
    then covers every slot; the port clamps explicitly."""
    arch = "zamba2-7b"
    assert (R.P, R.STEPS, R.MAX_LEN) == (3, 8, 12)
    fed, _, want_caches = R.decoded(arch)
    _, caches = port_decode(arch, len(fed))
    shared = caches[-1]["shared"]
    assert int(shared["idx"]) == 2 * len(fed) == 20 > R.MAX_LEN
    assert int(want_caches[-1]["shared"]["idx"]) == 20
    assert_leaves_close(shared, want_caches[-1]["shared"], "shared cache")
    # the overrun writes went to the last slot: it changed after the cache
    # filled, the earlier slots did not
    full = caches[R.MAX_LEN // 2 - 1]["shared"]
    assert int(full["idx"]) == R.MAX_LEN
    assert torch.equal(full["k"][:, :-1], shared["k"][:, :-1])
    assert not torch.equal(full["k"][:, -1], shared["k"][:, -1])


@pytest.mark.parametrize("arch", ALL)
def test_temperature_sampling_is_seeded(arch):
    a = port_generate(arch, temperature=0.8, seed=5)
    b = port_generate(arch, temperature=0.8, seed=5)
    c = port_generate(arch, temperature=0.8, seed=6)
    assert a.shape == (R.B, R.STEPS) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    cfg = smoke_config(arch)
    assert ((a >= 0) & (a < cfg.vocab)).all()


# not zamba2: its one shared attention cache is written by every shared
# block (twice per token here), so at decode each block also attends to
# the other's keys, in the reference as in the port; no batch forward
# computes that
@pytest.mark.parametrize("arch", [a for a in ALL if a != "zamba2-7b"])
def test_prefill_by_decode_equals_lm_apply(arch):
    """Prefill by decode steps (what generate does) gives the batch
    forward's last logits: the caches against the full-sequence paths
    (mamba2: the SSM recurrence against ssd_chunked over 2 chunks).
    MoE capacity depends on the tokens routed together (one step's B
    tokens at decode, all B*S in the forward), so the two drop different
    assignments at the published capacity factor; the check runs MoE at
    a capacity factor of n_experts, where nothing is dropped."""
    cfg = smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    tokens, _, frontend = R.inputs(arch)
    params = port_params(arch)
    fe = None
    if cfg.enc_dec:
        fe = torch.from_numpy(frontend)
    with torch.no_grad():
        logits, cache = prefill(cfg, params, tokens, R.S + 1, fe)
        full, _ = T.lm_apply(cfg, params, tokens, fe)
    assert int(cache["pos"]) == R.S
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), rtol=0,
                               atol=LOGIT_ATOL)


def test_generate_takes_tensor_prompts():
    arch = "h2o-danube-3-4b"
    _, prompts, _ = R.inputs(arch)
    a = port_generate(arch)
    b = generate(smoke_config(arch), port_params(arch),
                 torch.from_numpy(prompts), R.STEPS, device="cpu")
    np.testing.assert_array_equal(a, b)


def test_generate_enc_dec_needs_frames():
    arch = "whisper-medium"
    with pytest.raises(ValueError, match="frontend"):
        generate(smoke_config(arch), port_params(arch),
                 R.inputs(arch)[1], 2, device="cpu")


def test_entry_points_default_to_cuda():
    """Without device=, init_params, init_cache and generate run on cuda:
    without a card they raise and name device='cpu'; with one,
    generate refuses parameters that lie on the CPU."""
    cfg = smoke_config("minitron-4b")
    prompts = R.inputs("minitron-4b")[1]
    if torch.cuda.is_available():
        assert T.init_params(cfg).embed.device.type == "cuda"
        assert T.init_cache(cfg, 1, 4)["pos"].device.type == "cuda"
        with pytest.raises(ValueError, match="parameters are on cpu"):
            generate(cfg, port_params("minitron-4b"), prompts, 2)
        return
    for call in (lambda: T.init_params(cfg),
                 lambda: T.init_cache(cfg, 1, 4),
                 lambda: generate(cfg, port_params("minitron-4b"), prompts,
                                  2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_import_loads_neither_jax_nor_repro():
    mods = ["repro_torch.models", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.convert", "repro_torch.configs",
            "repro_torch.serve.engine"] + [
        f"repro_torch.configs.{m}" for m in ARCHS.values()]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\nassert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
