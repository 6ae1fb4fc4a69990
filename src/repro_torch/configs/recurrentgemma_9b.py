"""recurrentgemma-9b [hybrid] — RG-LRU + local attn 2:1 [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    layer_pattern="RRL", sliding_window=2048, rnn_width=4096,
    act="gelu", norm="rmsnorm", tie_embeddings=True, embed_scale=True,
)

REDUCED = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_pattern="RRL", sliding_window=16, rnn_width=64,
    act="gelu", norm="rmsnorm", tie_embeddings=True, embed_scale=True,
)
