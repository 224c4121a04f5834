"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv=8, d_ff=10240, vocab=32000, window=4096,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="danube-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
                       window=8)
