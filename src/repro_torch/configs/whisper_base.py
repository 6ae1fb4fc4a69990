"""whisper-base [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6,
    d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    layer_pattern="G",
    act="gelu", mlp_gated=False, norm="layernorm",
    tie_embeddings=True, frontend="audio",
)

REDUCED = ModelConfig(
    name="whisper-base-smoke", family="encdec",
    num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_pattern="G", act="gelu", mlp_gated=False, norm="layernorm",
    tie_embeddings=True, frontend="audio",
)
