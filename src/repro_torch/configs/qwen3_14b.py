"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936,
    layer_pattern="G", qk_norm=True, rope_theta=1e6,
    act="silu", norm="rmsnorm", tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="qwen3-14b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_pattern="G", qk_norm=True, rope_theta=1e6,
    act="silu", norm="rmsnorm", tie_embeddings=False,
)
