"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    layer_pattern="K",
    act="silu", norm="layernorm", tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
    d_ff=256, vocab_size=512,
    layer_pattern="K",
    act="silu", norm="layernorm", tie_embeddings=True,
)
