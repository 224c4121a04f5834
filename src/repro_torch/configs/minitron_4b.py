"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv=8, d_ff=9216, vocab=256000,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="minitron-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
