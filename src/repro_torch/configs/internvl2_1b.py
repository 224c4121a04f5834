"""internvl2-1b [vlm] — InternViT (stub) + InternLM2/Qwen2 backbone
[arXiv:2404.16821]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv=2, d_ff=4864, vocab=151655, head_dim=64,
    frontend="vision_stub", n_patches=256,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="internvl2-smoke", family="vlm", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
                       frontend="vision_stub", n_patches=8)
