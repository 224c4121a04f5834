"""Architecture registry + per-(arch, shape) input specs for the dry-run.

The port's counterpart of ``repro.configs.registry``: the same ten
architecture tables (one module each, ``CONFIG`` and ``smoke_config()``),
with ``input_specs`` giving ``meta``-device tensors (shape and dtype, no
storage) where the JAX package gives ``ShapeDtypeStruct``s."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.models.config import (SHAPES, ModelConfig, ShapeSpec,
                                       long_ok)

ARCHS = {
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-medium": "whisper_medium",
    "minitron-4b": "minitron_4b",
    "qwen2.5-32b": "qwen2_5_32b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "minicpm3-4b": "minicpm3_4b",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-1b": "internvl2_1b",
}


def _mod(name: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _mod(name).smoke_config()


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k needs a decode state that does not grow with the
    sequence: SSM, hybrid or sliding-window attention."""
    if shape.name == "long_500k":
        return long_ok(cfg)
    return True


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, object]:
    """``meta`` tensors (shape + dtype, no storage) standing in for every
    model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        spec = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        if cfg.enc_dec:
            # audio stub: precomputed frame embeddings
            spec["frontend"] = sds((B, S, cfg.d_model), bf16)
        elif cfg.frontend == "vision_stub":
            spec["frontend"] = sds((B, cfg.n_patches, cfg.d_model), bf16)
        return spec
    if shape.kind == "prefill":
        spec = {"tokens": sds((B, S), i32)}
        if cfg.enc_dec:
            spec["frontend"] = sds((B, cfg.enc_len, cfg.d_model), bf16)
        elif cfg.frontend == "vision_stub":
            spec["frontend"] = sds((B, cfg.n_patches, cfg.d_model), bf16)
        return spec
    # decode: one new token against a cache of length S
    return {"token": sds((B,), i32)}
