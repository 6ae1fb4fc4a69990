"""Architecture registry: ``--arch <id>`` resolution, per-cell input specs,
and per-(arch x shape) runnability rules (long_500k skip list etc.).

``input_specs`` returns :class:`InputSpec` records — a shape and a dtype
name (``"int32"``, ``"bfloat16"``) — where the JAX package returns
``jax.ShapeDtypeStruct``; numpy has no bfloat16, and a name compares equal
to ``np.dtype`` of the same type (``np.dtype("int32") == "int32"``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, RunConfig, SHAPE_CELLS, ShapeCell

ARCH_MODULES = {
    "whisper-base": "repro_torch.configs.whisper_base",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

ARCH_IDS = list(ARCH_MODULES)

# long_500k needs a sub-quadratic/KV-bounded decode path; pure full-attention
# archs are skipped per the assignment (DESIGN.md §6).  gemma2-2b runs: its
# local layers use a rolling window cache and its global layers' decode is
# O(S) per token.
LONG_CONTEXT_ARCHS = {"rwkv6-1.6b", "recurrentgemma-9b", "gemma2-2b"}

# archs where params+optimizer must shard over data too (FSDP)
FSDP_ARCHS = {"qwen3-14b", "deepseek-7b", "internvl2-76b", "dbrx-132b",
              "recurrentgemma-9b"}


class InputSpec(NamedTuple):
    """Shape and dtype name of one model input (no allocation)."""

    shape: tuple
    dtype: str


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG


def cell_runnable(arch: str, cell_name: str) -> tuple[bool, str]:
    """(runnable, reason-if-not) for an (arch, shape-cell) pair."""
    if cell_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k decode cache excluded by assignment"
    return True, ""


def default_run_config(arch: str, cell: ShapeCell,
                       n_devices: int = 256) -> RunConfig:
    fsdp = arch in FSDP_ARCHS
    micro = 1
    if cell.kind == "train":
        micro = 4 if arch in ("internvl2-76b", "dbrx-132b") else 2
    return RunConfig(
        sharding_mode="fsdp" if fsdp else "tp",
        remat="block" if cell.kind == "train" else "none",
        microbatch=micro,
        q_chunk=min(512, cell.seq_len),
        kv_chunk=min(512, cell.seq_len),
        loss_chunk=min(512, cell.seq_len),
    )


# ---------------------------------------------------------------------------
# input specs: (shape, dtype) stand-ins for every model input
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: ShapeCell,
                batch_override: Optional[int] = None) -> dict:
    """Abstract inputs for (arch, cell) — no allocation, dry-run safe.

    train:   tokens [B, S] + labels [B, S] (+ frontend embeds)
    prefill: tokens [B, S] (+ frontend embeds)
    decode:  token [B, 1] + cache handled by the serve step builder
    """
    B = batch_override or cell.global_batch
    S = cell.seq_len
    i32 = "int32"
    f32 = "bfloat16"
    sd = InputSpec

    if cfg.encoder_layers > 0:  # whisper: enc frames stub + decoder tokens
        enc_len = S // 2
        specs = {
            "enc_frames": sd((B, enc_len, cfg.d_model), f32),
            "tokens": sd((B, S), i32),
        }
        if cell.kind == "train":
            specs["labels"] = sd((B, S), i32)
        if cell.kind == "decode":
            specs["tokens"] = sd((B, 1), i32)
        return specs

    if cfg.frontend == "vision":
        ft = cfg.frontend_tokens
        specs = {
            "patch_embeds": sd((B, ft, cfg.d_model), f32),
            "tokens": sd((B, S - ft), i32),
        }
        if cell.kind == "train":
            specs["labels"] = sd((B, S), i32)
        if cell.kind == "decode":
            specs = {"tokens": sd((B, 1), i32)}
        return specs

    if cell.kind == "decode":
        return {"tokens": sd((B, 1), i32)}
    specs = {"tokens": sd((B, S), i32)}
    if cell.kind == "train":
        specs["labels"] = sd((B, S), i32)
    return specs


def synthetic_batch(cfg: ModelConfig, cell: ShapeCell, batch: int,
                    seq: Optional[int] = None, seed: int = 0) -> dict:
    """Concrete random batch matching input_specs (for smoke tests/examples)."""
    rng = np.random.default_rng(seed)
    cell2 = dataclasses.replace(cell, seq_len=seq or cell.seq_len,
                                global_batch=batch)
    out: dict = {}
    for k, spec in input_specs(cfg, cell2).items():
        if k in ("tokens", "labels"):
            out[k] = rng.integers(0, cfg.vocab_size, spec.shape).astype(np.int32)
        else:
            out[k] = rng.normal(size=spec.shape).astype(np.float32)
    return out
