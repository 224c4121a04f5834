"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2),
    shared_attn_every=6,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="zamba2-smoke", family="hybrid", n_layers=4,
                       d_model=64, n_heads=4, n_kv=4, head_dim=16, d_ff=128,
                       vocab=256, ssm=SSMCfg(d_state=16, head_dim=16,
                                             expand=2, chunk=8),
                       shared_attn_every=2)
