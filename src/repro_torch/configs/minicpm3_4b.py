"""minicpm3-4b [dense] — MLA [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.models.config import MLACfg, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv=40, d_ff=6400, vocab=73448,
    mla=MLACfg(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64),
)

def smoke_config() -> ModelConfig:
    return ModelConfig(name="minicpm3-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
                       mla=MLACfg(q_lora=32, kv_lora=16, qk_nope=8,
                                  qk_rope=8, v_head=8))
