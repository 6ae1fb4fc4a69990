"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    layer_pattern="G", rope_theta=5e5,
    moe=True, num_experts=16, experts_per_token=4,
    act="silu", norm="rmsnorm", tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512,
    layer_pattern="G", moe=True, num_experts=4, experts_per_token=2,
    act="silu", norm="rmsnorm", tie_embeddings=False,
)
