"""internvl2-76b [vlm] — InternViT (stubbed) + 70B-class LLM [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    layer_pattern="G", rope_theta=5e5,
    act="silu", norm="rmsnorm", tie_embeddings=False,
    frontend="vision", frontend_tokens=256,
)

REDUCED = ModelConfig(
    name="internvl2-76b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_pattern="G", act="silu", norm="rmsnorm", tie_embeddings=False,
    frontend="vision", frontend_tokens=8,
)
