"""gemma2-2b [dense] — local+global alternating, logit softcap [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    layer_pattern="LG", sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    act="gelu", norm="rmsnorm", tie_embeddings=True, embed_scale=True,
)

REDUCED = ModelConfig(
    name="gemma2-2b-smoke", family="dense",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_pattern="LG", sliding_window=16,
    attn_softcap=50.0, logit_softcap=30.0,
    act="gelu", norm="rmsnorm", tie_embeddings=True, embed_scale=True,
)
