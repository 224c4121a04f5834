"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv=8, d_ff=27648, vocab=152064, qkv_bias=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="qwen-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
                       qkv_bias=True)
