"""The JAX package's LM substrate on the smoke configs, as the port's tests
hold it: one seeded parameter tree per architecture (``init_params``,
then ``np.asarray``), seeded numpy inputs, and the reference's results,
each computed once per process (JAX compilation is most of the cost, so
``tests/test_torch_archs.py`` and ``tests/test_torch_generate.py`` share
them when they run in one process).  Not a test module."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config
from repro.models import transformer as JT
from repro.serve import generate as jgenerate

B, S = 2, 16          # lm_apply batch and length
P, STEPS = 3, 8       # generate: prompt length and new tokens
MAX_LEN = P + STEPS + 1   # generate's default cache length


def bf16_exact(a):
    """float32 values that bf16 represents, so both packages' casts agree."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


@functools.lru_cache(maxsize=None)
def tree(arch):
    cfg = smoke_config(arch)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: JT.init_params(cfg, k))(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def inputs(arch):
    """tokens (B, S), prompts (B, P) and the frontend embeddings (or None),
    seeded by the architecture's name."""
    cfg = smoke_config(arch)
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    frontend = None
    if cfg.enc_dec:
        frontend = bf16_exact(rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)))
    elif cfg.frontend == "vision_stub":
        frontend = bf16_exact(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)))
    return tokens, prompts, frontend


@functools.lru_cache(maxsize=None)
def forward(arch):
    """The reference's jitted ``lm_apply``: (logits, aux) as numpy."""
    cfg = smoke_config(arch)
    tokens, _, frontend = inputs(arch)
    fe = None if frontend is None else jnp.asarray(frontend)
    logits, aux = jax.jit(lambda p, t, f: JT.lm_apply(cfg, p, t, f))(
        tree(arch), tokens, fe)
    return np.asarray(logits), float(aux)


@functools.lru_cache(maxsize=None)
def generated(arch):
    """``repro.serve.generate`` on the prompts, greedy: (B, STEPS)."""
    _, prompts, frontend = inputs(arch)
    fe = None if frontend is None else jnp.asarray(frontend)
    return jgenerate(smoke_config(arch), tree(arch), prompts, steps=STEPS,
                     frontend=fe)


def _np_tree(c):
    return jax.tree_util.tree_map(np.asarray, c)


@functools.lru_cache(maxsize=None)
def decoded(arch):
    """The reference's jitted ``decode_step`` fed the prompt and then its
    own generated tokens (teacher forcing), from ``init_cache(B,
    MAX_LEN)`` as ``generate`` builds it: (the fed tokens (n, B), the
    logits after each step (n, B, vocab_padded), the caches after steps
    1 and 2 and after the last one, as numpy trees)."""
    cfg = smoke_config(arch)
    params = tree(arch)
    _, prompts, frontend = inputs(arch)
    cache = JT.init_cache(cfg, B, MAX_LEN)
    if cfg.enc_dec:
        cache = dict(cache, enc_out=JT._encoder_apply(
            cfg, params, jnp.asarray(frontend))
            .astype(cache["enc_out"].dtype))
    fed = np.concatenate([prompts.T, generated(arch)[:, :-1].T])
    step = jax.jit(lambda p, c, t: JT.decode_step(cfg, p, c, t))
    logits, caches = [], []
    for t in fed:
        lg, cache = step(params, cache, jnp.asarray(t))
        logits.append(np.asarray(lg))
        if len(caches) < 2:
            caches.append(_np_tree(cache))
    return fed, np.stack(logits), caches + [_np_tree(cache)]
