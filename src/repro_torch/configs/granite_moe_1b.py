"""granite-moe-1b-a400m [moe] — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    layer_pattern="G",
    moe=True, num_experts=32, experts_per_token=8,
    act="silu", norm="rmsnorm", tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="granite-moe-1b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512,
    layer_pattern="G", moe=True, num_experts=4, experts_per_token=2,
    act="silu", norm="rmsnorm", tie_embeddings=True,
)
