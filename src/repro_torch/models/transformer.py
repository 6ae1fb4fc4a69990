"""Decoder-only LM over the dense layer patterns ``G`` (global attention)
and ``L`` (sliding-window attention) — counterpart of
``repro/models/transformer.py``.

The reference stacks full cycles of ``cfg.layer_pattern`` and scans over
them; here :class:`LM` holds its blocks in a ``ModuleList`` in the order
they run (cycle c applies pattern[0], pattern[1], ... in turn, then the
tail), so block ``c·len(pattern) + i`` is the reference's stacked leaf
``cycles/<i><kind>[c]`` and block ``n_cycles·len(pattern) + i`` its
``tail/<i><kind>`` (``model_zoo.load_params`` / ``export_params``).  A
cache is a list of ``{"k", "v"}`` tensors ``[B, S, Hkv, Dh]``, one a
block; the writes go into it in place.

Three entry modes share the block code:
  train   — full-sequence forward, no cache, blockwise attention
  prefill — full-sequence forward building a decode cache
  decode  — one token per step against the cache

Layer kinds ``R`` (RG-LRU) and ``K`` (RWKV6) and mixture-of-experts FFNs
are ROADMAP.md A.13.3; ``loss``/``chunked_xent`` come with training
(A.13.2).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L

_LATER_KINDS = {"R": "RG-LRU", "K": "RWKV6"}


def padded_vocab(cfg: ModelConfig) -> int:
    """Physical vocab rounded up to 256 (the reference's, so that the vocab
    axis shards over a model axis of 16).  Logits for pad rows are masked to
    -1e30; labels never reference them."""
    return ((cfg.vocab_size + 255) // 256) * 256


def _mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    vpad = logits.shape[-1]
    if vpad == cfg.vocab_size:
        return logits
    ids = torch.arange(vpad, device=logits.device)
    return torch.where(ids >= cfg.vocab_size,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device), logits)


def _check_kind(kind: str) -> None:
    if kind in _LATER_KINDS:
        raise NotImplementedError(
            f"layer kind {kind} ({_LATER_KINDS[kind]}) is not ported yet "
            "(ROADMAP.md A.13.3)")
    if kind not in ("G", "L"):
        raise ValueError(f"unknown layer kind {kind}")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this slice does not serve."""
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts FFNs are not ported yet "
            "(ROADMAP.md A.13.3)")
    for kind in cfg.layer_pattern:
        _check_kind(kind)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """One block's K/V buffers: max_len positions for ``G``, the last
    min(max_len, sliding_window) for ``L`` (a rolling buffer)."""
    _check_kind(kind)
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    s = max_len if kind == "G" else min(max_len, cfg.sliding_window)
    return {"k": torch.zeros((batch, s, hkv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, s, hkv, dh), dtype=dtype, device=device)}


def _write_prefill_cache(cache_kv: dict, k, v, window: Optional[int]) -> dict:
    """Write full-sequence K/V into a (possibly rolling) cache buffer."""
    S = k.shape[1]
    W = cache_kv["k"].shape[1]
    if window is None or S <= W:
        n = min(S, W)
        cache_kv["k"][:, :n] = k[:, :n].to(cache_kv["k"].dtype)
        cache_kv["v"][:, :n] = v[:, :n].to(cache_kv["v"].dtype)
        return cache_kv
    # rolling: keep the last W entries at slot = pos % W
    slots = (S - W + torch.arange(W, device=k.device)) % W
    cache_kv["k"][:, slots] = k[:, -W:].to(cache_kv["k"].dtype)
    cache_kv["v"][:, slots] = v[:, -W:].to(cache_kv["v"].dtype)
    return cache_kv


def _write_decode_cache(cache_kv: dict, k1, v1, cache_len,
                        window: Optional[int]) -> dict:
    """cache_len: scalar or per-batch [B] — per-slot lengths enable the
    continuous-batching serve engine.  Slot cl % W in a window, else
    min(cl, W - 1)."""
    B, W = cache_kv["k"].shape[0], cache_kv["k"].shape[1]
    cl = torch.as_tensor(cache_len, device=k1.device).long().expand(B)
    slot = cl % W if window is not None else torch.clamp(cl, max=W - 1)
    b = torch.arange(B, device=k1.device)
    cache_kv["k"][b, slot] = k1[:, 0].to(cache_kv["k"].dtype)
    cache_kv["v"][b, slot] = v1[:, 0].to(cache_kv["v"].dtype)
    return cache_kv


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """An attention block of kind ``G`` or ``L`` (``block_init``): ln1,
    attn, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, kind: str,
                 device=None):
        super().__init__()
        _check_kind(kind)
        self.cfg, self.run, self.kind = cfg, run, kind
        self.ln1 = L.Norm(cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg.d_model, device)
        self.mlp = L.MLP(cfg, device=device)

    def init(self, gen: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.init(gen)

    def forward(self, x, mode: str, cache, cache_len, positions):
        """Returns (x, cache)."""
        cfg, run = self.cfg, self.run
        window = cfg.sliding_window if self.kind == "L" else None
        h = self.ln1(x, cfg.norm, cfg.norm_eps)
        q, k, v = self.attn.qkv(h, positions)
        sdt = getattr(torch, run.scores_dtype)
        if mode in ("train", "prefill"):
            o = L.blockwise_attention(
                q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
                q_chunk=run.q_chunk, kv_chunk=run.kv_chunk, scores_dtype=sdt)
            if mode == "prefill":
                cache = _write_prefill_cache(cache, k, v, window)
        elif mode == "decode":
            cache = _write_decode_cache(cache, k, v, cache_len, window)
            cl = torch.as_tensor(cache_len, device=x.device) + 1
            if window is not None:
                cl = torch.clamp(cl, max=cache["k"].shape[1])
            o = L.decode_attention(q, cache["k"], cache["v"], cl,
                                   window=None, softcap=cfg.attn_softcap)
        else:
            raise ValueError(f"unknown mode {mode}")
        x = x + self.attn.out(o)
        h = self.ln2(x, cfg.norm, cfg.norm_eps)
        return x + self.mlp(h), cache


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The decoder-only LM: ``embed_tok [padded_vocab, d_model]``,
    ``final_norm``, ``blocks`` in the order they run and, untied,
    ``lm_head [d_model, padded_vocab]``; float32 parameters on ``device``,
    uninitialised until :meth:`init` or ``model_zoo.load_params``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig = RunConfig(),
                 device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.run = cfg, run
        vp = padded_vocab(cfg)
        self.embed_tok = L.new_param(vp, cfg.d_model, device=device)
        self.final_norm = L.Norm(cfg.d_model, device)
        self.blocks = nn.ModuleList(
            Block(cfg, run, kind, device) for kind in self.block_kinds)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.new_param(cfg.d_model, vp, device=device))

    # -- structure ------------------------------------------------------
    @property
    def pattern(self) -> str:
        return self.cfg.layer_pattern

    @property
    def n_full_cycles(self) -> int:
        return self.cfg.num_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> list[str]:
        rem = self.cfg.num_layers % len(self.pattern)
        return list(self.pattern[:rem])

    @property
    def block_kinds(self) -> list[str]:
        """Kinds in the order the blocks run: the cycles, then the tail."""
        return list(self.pattern) * self.n_full_cycles + self.tail_kinds

    @property
    def device(self) -> torch.device:
        return self.embed_tok.device

    # -- init -----------------------------------------------------------
    def init(self, seed: int = 0) -> "LM":
        """Random parameters from a ``torch.Generator`` on the model's
        device seeded with ``seed`` (the reference's scheme: normal
        embeddings · 0.02, dense weights normal / sqrt(fan_in), norm scales
        1; another generator, so other values than ``LM.init`` of the
        JAX package — carry those across with ``model_zoo.load_params``).
        Returns the model."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.no_grad():
            self.embed_tok.normal_(generator=gen).mul_(0.02)
            self.final_norm.init(gen)
            for blk in self.blocks:
                blk.init(gen)
            if self.lm_head is not None:
                self.lm_head.normal_(generator=gen).mul_(0.02)
        return self

    # -- caches ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> list:
        """One ``cache_init`` a block, on the model's device."""
        return [cache_init(self.cfg, kind, batch, max_len, dtype, self.device)
                for kind in self.block_kinds]

    # -- forward ---------------------------------------------------------
    def _embed(self, tokens, extra_embeds):
        cfg = self.cfg
        cdt = getattr(torch, self.run.compute_dtype)
        x = self.embed_tok[torch.as_tensor(tokens, device=self.device)
                           .long()].to(cdt)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(cdt), x], dim=1)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt,
                                 device=x.device)
        return x

    def hidden(self, tokens, extra_embeds=None, mode="train", cache=None,
               cache_len=None, positions=None):
        """Final-normed hidden states ``[B, S, D]`` and the cache (written
        in place in prefill and decode; None in train)."""
        x = self._embed(tokens, extra_embeds)
        B, S = x.shape[0], x.shape[1]
        if positions is None:
            if mode == "decode":
                cl = torch.as_tensor(0 if cache_len is None else cache_len,
                                     device=x.device)
                positions = cl.to(torch.int32).expand(B)[:, None]  # [B, 1]
            else:
                positions = torch.arange(S, device=x.device)[None, :]
        if mode != "train" and cache is None:
            raise ValueError(f"mode {mode!r} needs a cache")
        for i, blk in enumerate(self.blocks):
            c = None if cache is None else cache[i]
            x, c = blk(x, mode, c, cache_len, positions)
            if cache is not None:
                cache[i] = c
        x = self.final_norm(x, self.cfg.norm, self.cfg.norm_eps)
        return x, cache

    def unembed(self) -> torch.Tensor:
        """``[D, padded_vocab]``: the embedding's transpose when tied."""
        if self.cfg.tie_embeddings:
            return self.embed_tok.t()
        return self.lm_head

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        cdt = hidden.dtype
        logits = hidden @ self.unembed().to(cdt)
        cap = self.cfg.logit_softcap
        if cap:
            logits = torch.tanh(logits / cap) * cap
        return _mask_pad_logits(logits, self.cfg)

    # -- serving ----------------------------------------------------------
    def prefill(self, tokens, cache, extra_embeds=None):
        """Returns (cache, last_position_logits ``[B, 1, V]``)."""
        h, cache = self.hidden(tokens, extra_embeds, mode="prefill",
                               cache=cache, cache_len=None)
        return cache, self.logits(h[:, -1:])

    def decode_step(self, token, cache, cache_len):
        """token: [B, 1] -> (cache, logits [B, 1, V])."""
        h, cache = self.hidden(token, mode="decode", cache=cache,
                               cache_len=cache_len)
        return cache, self.logits(h)

