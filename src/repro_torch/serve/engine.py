"""Serving engines at the RPC boundary: payloads, not live objects.

The counterpart of ``repro.serve.engine``; two workloads share its
contract:

- :func:`generate` — LM decode: prefill the prompt, then greedy /
  temperature decode with the arch-appropriate cache (KV / SWA ring /
  MLA latent / SSM state); returns plain token arrays.
- :func:`serve_topo` runs one :class:`~repro_torch.pipeline.TopoRequest`
  and returns the DDMS v1 wire payload (``bytes``, decodable by either
  package's ``DiagramResult.from_bytes``); :func:`stats_payload` is a
  :class:`~repro_torch.serve.TopoService`'s telemetry as JSON bytes.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _resolve_device


def topo_payload(result) -> bytes:
    """Serialize a :class:`DiagramResult` for the RPC boundary."""
    return result.to_bytes()


def serve_topo(request, *, pipeline=None) -> bytes:
    """Execute one :class:`TopoRequest` and return its wire payload.

    ``pipeline`` is an optional configured :class:`PersistencePipeline`;
    the default one runs on the card."""
    from repro_torch.pipeline import PersistencePipeline
    pipe = pipeline or PersistencePipeline()
    return topo_payload(pipe.run(request))


def stats_payload(service) -> bytes:
    """A :class:`TopoService`'s telemetry snapshot as JSON bytes: the
    serving counters and the metric summaries of ``service.stats()`` (a
    copy, never a view of live state)."""
    return json.dumps(service.stats(), sort_keys=True).encode("utf-8")


# --------------------------------------------------------------------------
# LM decode serving
# --------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, prompts, max_len: int, frontend=None):
    """The prompt ``prompts`` (B, P) through P decode steps into a fresh
    cache of ``max_len`` on the parameters' device: (logits of the last
    prompt token (B, vocab_padded) f32, cache).  For attention caches this
    is mathematically the batch forward ``lm_apply(prompts)[:, -1]``."""
    dev = T._params(params)["embed"].device
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape
    cache = T.init_cache(cfg, B, max_len, device=dev)
    if cfg.enc_dec:
        if frontend is None:
            raise ValueError(f"{cfg.name} is encoder-decoder: pass the "
                             "encoder frames as frontend=")
        cache = dict(cache, enc_out=T._encoder_apply(cfg, params, frontend)
                     .to(cache["enc_out"].dtype))
    logits = None
    for i in range(P):
        logits, cache = T.decode_step(cfg, params, cache, prompts[:, i])
    return logits, cache


def generate(cfg: ModelConfig, params, prompts, steps: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0, frontend=None, *, device=None):
    """prompts: (B, P) int tokens, an ndarray or a tensor.  Returns the
    (B, steps) generated tokens as an int32 ndarray.

    Runs on ``device`` (``cuda`` unless named), where the parameters must
    lie.  Prefill runs the prompt through decode steps (cache-building),
    the first token comes from the prefill logits, and every later one
    costs one decode step.  Greedy (argmax) at ``temperature=0``, else
    Gumbel-max sampling of ``logits / temperature`` from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = _resolve_device(device)
    at = T._params(params)["embed"].device
    if at.type != dev.type:
        raise ValueError(f"the parameters are on {at}, generate runs on "
                         f"{dev}")
    with torch.no_grad():
        prompts = torch.as_tensor(prompts, device=dev)
        B, P = prompts.shape
        max_len = max_len or (P + steps + 1)
        logits, cache = prefill(cfg, params, prompts, max_len, frontend)
        gen = torch.Generator(device=dev).manual_seed(seed) \
            if temperature > 0 else None
        out = []
        tok = None
        for i in range(steps):
            if tok is None:
                src = logits
            else:
                src, cache = T.decode_step(cfg, params, cache, tok)
            if temperature > 0:
                u = torch.rand(src.shape, generator=gen, device=dev)
                u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
                gumbel = -torch.log(-torch.log(u))
                tok = torch.argmax(src / temperature + gumbel, dim=-1)
            else:
                tok = torch.argmax(src, dim=-1)
            tok = tok.to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()
