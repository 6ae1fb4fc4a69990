"""Model / run configuration dataclasses and the shape-cell registry."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # layer pattern, cycled over the layer stack:
    #   G = global attention block   L = sliding-window attention block
    #   R = RG-LRU recurrent block   K = RWKV6 block
    # MoE applies to the FFN of every block when moe=True.
    layer_pattern: str = "G"

    # attention features
    qk_norm: bool = False
    attn_softcap: Optional[float] = None       # gemma2: 50.0
    logit_softcap: Optional[float] = None      # gemma2: 30.0
    rope_theta: float = 10000.0
    sliding_window: int = 4096

    # MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # recurrent (RG-LRU / RWKV6)
    rnn_width: int = 0               # 0 -> d_model
    conv_width: int = 4

    # encoder-decoder (whisper)
    encoder_layers: int = 0          # >0 => enc-dec; num_layers = decoder layers

    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_tokens: int = 256       # vision: patch embeddings prepended

    act: str = "silu"                # silu | gelu
    mlp_gated: bool = True           # gated (llama-style) vs plain 2-layer MLP
    embed_scale: bool = False        # gemma-style sqrt(d_model) embed scaling
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer needs a full-length KV cache for decode that
        grows quadratically with context in prefill (SSM/hybrid/local)."""
        return not any(c == "G" for c in self.layer_pattern)

    def pattern_for_layers(self) -> list[str]:
        pat = self.layer_pattern
        return [pat[i % len(pat)] for i in range(self.num_layers)]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Parallelism / numerics knobs resolved per (arch x shape x mesh)."""

    sharding_mode: str = "fsdp"      # "tp" (DP+TP) | "fsdp" (adds param sharding over data)
    param_dtype: str = "float32"     # master params
    compute_dtype: str = "bfloat16"
    remat: str = "block"             # none | block | full
    microbatch: int = 1              # grad-accumulation steps
    loss_chunk: int = 2048           # sequence chunk for vocab-sharded loss
    q_chunk: int = 1024              # blockwise attention chunks
    kv_chunk: int = 1024
    zero1: bool = True               # shard optimizer state over data axis
    grad_compression: str = "none"   # none | bf16 | topk  (GraphH hybrid comm)
    seq_shard_decode: bool = False   # flash-decoding over the data axis
    # --- §Perf knobs (baselines use the defaults) ---
    attn_shard: str = "heads"        # "heads" | "flat": constrain qkv on the
    #   flattened H*Dh dim (always divisible) instead of the head dim —
    #   keeps the projections tensor-parallel when H % tp_size != 0
    tp_comm: str = "activation"      # "activation" | "weight": weight-gathered
    #   TP for long-sequence inference (all-gather weights, not activations)
    scores_dtype: str = "float32"    # attention probability dtype (bf16 opt)
