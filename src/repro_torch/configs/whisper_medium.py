"""whisper-medium [audio] — enc-dec, conv frontend stub [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv=16, d_ff=4096, vocab=51865,
    enc_dec=True, enc_layers=24, frontend="audio_stub", enc_len=1500,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="whisper-smoke", family="audio", n_layers=2,
                       d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
                       enc_dec=True, enc_layers=2, frontend="audio_stub",
                       enc_len=24)
