"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=1, n_kv=1, head_dim=64, d_ff=0, vocab=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2),
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="mamba2-smoke", family="ssm", n_layers=2,
                       d_model=64, n_heads=1, n_kv=1, head_dim=16, d_ff=0,
                       vocab=256, ssm=SSMCfg(d_state=16, head_dim=16,
                                             expand=2, chunk=8))
