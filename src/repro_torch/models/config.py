"""Model + shape configuration for the assigned architecture pool.

The port's own copy of ``repro.models.config`` (the tables import
nothing of JAX, but the port imports nothing of the JAX package): the
same dataclasses, shapes, ``long_ok`` and parameter counts."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int            # expert FFN hidden size
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLACfg:
    q_lora: int = 768
    kv_lora: int = 256
    qk_nope: int = 64
    qk_rope: int = 32
    v_head: int = 64


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    window: Optional[int] = None          # sliding-window attention
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid: every `shared_attn_every` layers, a single *shared* attention
    # block (zamba2 style) runs in addition to the SSM block
    shared_attn_every: Optional[int] = None
    enc_dec: bool = False                 # whisper-style encoder-decoder
    enc_layers: int = 0
    frontend: Optional[str] = None        # "audio_stub" | "vision_stub"
    n_patches: int = 256                  # vision stub tokens
    enc_len: int = 1500                   # whisper canonical encoder length
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # dry-run exact-cost mode of the JAX package (unrolled layer scans);
    # kept so configs compare equal, and without effect here: eager torch
    # runs every layer as a Python loop iteration anyway
    unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        # pad to a multiple of 2048 so embeddings/logits shard cleanly
        # (16-way tensor parallel x 128-wide tiles)
        return -(-self.vocab // 2048) * 2048

    def param_count(self) -> int:
        """Total parameters (for 6*N*D model-FLOPs accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        n = v * d * (1 if self.tie_embeddings else 2)   # embed (+unembed)
        per_layer = 0
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            per_layer += d * (2 * di + 2 * self.ssm.d_state + nh) \
                + di * self.ssm.d_conv + di * d + 2 * nh
        if self.mla is not None:
            m = self.mla
            per_layer += d * m.q_lora \
                + m.q_lora * self.n_heads * (m.qk_nope + m.qk_rope) \
                + d * (m.kv_lora + m.qk_rope) \
                + m.kv_lora * self.n_heads * (m.qk_nope + m.v_head) \
                + self.n_heads * m.v_head * d
        elif self.ssm is None or self.shared_attn_every:
            att = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                + self.n_heads * hd * d
            if self.ssm is None:
                per_layer += att
        if self.moe is not None:
            per_layer += d * self.moe.n_experts \
                + self.moe.n_experts * 3 * d * self.moe.d_expert
        elif self.ssm is None:
            per_layer += 3 * d * f                       # SwiGLU
        n += self.n_layers * per_layer
        if self.shared_attn_every:
            n += d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                + self.n_heads * hd * d                  # one shared block
        if self.enc_dec:
            # encoder layers + decoder cross-attention
            enc = self.enc_layers * (2 * (d * self.n_heads * hd
                                          + 2 * d * self.n_kv * hd
                                          + self.n_heads * hd * d) // 2
                                     + 3 * d * f)
            n += enc + self.n_layers * (d * self.n_heads * hd
                                        + 2 * d * self.n_kv * hd
                                        + self.n_heads * hd * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_all = self.n_layers * self.moe.n_experts * 3 * self.d_model \
            * self.moe.d_expert
        moe_act = self.n_layers * self.moe.top_k * 3 * self.d_model \
            * self.moe.d_expert
        return full - moe_all + moe_act


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs able to run long_500k (sub-quadratic decode state)
LONG_OK_FAMILIES = {"ssm", "hybrid"}


def long_ok(cfg: ModelConfig) -> bool:
    return cfg.family in LONG_OK_FAMILIES or cfg.window is not None
