"""Decoder-only LM over heterogeneous layer patterns — counterpart of
``repro/models/transformer.py``.  Layer kinds: ``G`` (global attention),
``L`` (sliding-window attention), ``R`` (RG-LRU, ``models/rglru.py``) and
``K`` (RWKV6, ``models/rwkv6.py``); with ``cfg.moe`` the attention blocks'
FFN is a mixture of experts (``models/moe.py``).

The reference stacks full cycles of ``cfg.layer_pattern`` and scans over
them; here :class:`LM` holds its blocks in a ``ModuleList`` in the order
they run (cycle c applies pattern[0], pattern[1], ... in turn, then the
tail), so block ``c·len(pattern) + i`` is the reference's stacked leaf
``cycles/<i><kind>[c]`` and block ``n_cycles·len(pattern) + i`` its
``tail/<i><kind>`` (``model_zoo.load_params`` / ``export_params``).  A
cache is a list with one entry a block, written in place: ``{"k", "v"}``
``[B, S, Hkv, Dh]`` for ``G`` and ``L``, ``{"conv" [B, W-1, R], "h" [B,
R]}`` for ``R``, ``{"tmix": {"shift" [B, 1, D], "state" [B, H, 64, 64]},
"cmix": {"shift"}}`` for ``K`` (``h`` and ``state`` float32).

Three entry modes share the block code:
  train   — full-sequence forward, no cache, blockwise attention
  prefill — full-sequence forward building a decode cache
  decode  — one token per step against the cache

Training (``loss``, ``chunked_xent``) runs train mode with autograd: with
``run.remat`` "block" or "full" each cycle's blocks are one
``torch.utils.checkpoint`` region (``sharding.remat``: over a mesh the
recompute runs under the forward's mesh context; the reference
checkpoints its ``cycle_body``); the tail is not wrapped, as in the
reference.

A vision frontend's ``patch_embeds`` (``extra_embeds``) go before the
token embeddings, ahead of ``embed_scale``; a decode after a prefill of
F of them and S tokens runs at ``cache_len = F + S``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as K
from repro_torch.models.sharding import (cns, gather_last, gathered, linear,
                                         linear_f32, logsumexp, remat,
                                         write_slots_, write_span_)


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
    if kind not in ("G", "L", "R", "K"):
        raise ValueError(f"unknown layer kind {kind}")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """One block's cache: K/V buffers of max_len positions for ``G``, of
    the last min(max_len, sliding_window) for ``L`` (a rolling buffer);
    the recurrent states of ``R`` and ``K``."""
    _check_kind(kind)
    if kind == "R":
        return R.rnn_cache_init(batch, cfg, dtype, device)
    if kind == "K":
        return K.rwkv_cache_init(batch, cfg, dtype, device)
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    s = max_len if kind == "G" else min(max_len, cfg.sliding_window)
    return {"k": torch.zeros((batch, s, hkv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, s, hkv, dh), dtype=dtype, device=device)}


def _write_prefill_cache(cache_kv: dict, k, v, window: Optional[int]) -> dict:
    """Write full-sequence K/V into a (possibly rolling) cache buffer."""
    S = k.shape[1]
    W = cache_kv["k"].shape[1]
    for name, x in (("k", k), ("v", v)):
        buf = cache_kv[name]
        if window is None or S <= W:
            write_span_(buf, 0, x[:, :min(S, W)].to(buf.dtype))
            continue
        # rolling: the last W entries at slot = pos % W, entry j of them
        # at (S - W + j) % W — two spans of the buffer
        s = (S - W) % W
        x = x[:, -W:].to(buf.dtype)
        write_span_(buf, s, x[:, :W - s])
        if s:
            write_span_(buf, 0, x[:, W - s:])
    return cache_kv


def _write_decode_cache(cache_kv: dict, k1, v1, cache_len,
                        window: Optional[int]) -> dict:
    """cache_len: scalar or per-batch [B] — per-slot lengths enable the
    continuous-batching serve engine.  Slot cl % W in a window, else
    min(cl, W - 1)."""
    B, W = cache_kv["k"].shape[0], cache_kv["k"].shape[1]
    cl = torch.as_tensor(cache_len, device=k1.device).long().expand(B)
    slot = cl % W if window is not None else torch.clamp(cl, max=W - 1)
    write_slots_(cache_kv["k"], slot, k1[:, 0].to(cache_kv["k"].dtype))
    write_slots_(cache_kv["v"], slot, v1[:, 0].to(cache_kv["v"].dtype))
    return cache_kv


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One block (``block_init``): ln1, attn, ln2 and mlp — or moe — for
    ``G`` and ``L``; ln1, rnn, ln2, mlp for ``R``; ln1, ln2, rwkv for
    ``K``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, kind: str,
                 device=None):
        super().__init__()
        _check_kind(kind)
        self.cfg, self.run, self.kind = cfg, run, kind
        self.ln1 = L.Norm(cfg.d_model, device)
        if kind == "K":
            self.ln2 = L.Norm(cfg.d_model, device)
            self.rwkv = K.RWKV(cfg, device)
            return
        if kind == "R":
            self.rnn = R.RGLRU(cfg, device)
        else:
            self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg.d_model, device)
        if cfg.moe and kind != "R":
            self.moe = M.MoE(cfg, device)
        else:
            self.mlp = L.MLP(cfg, device=device)

    def init(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init(gen)

    def ffn(self, h):
        return self.moe(h) if hasattr(self, "moe") else self.mlp(h)

    def forward(self, x, mode: str, cache, cache_len, positions):
        """Returns (x, cache)."""
        cfg, run = self.cfg, self.run
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode}")
        c = cache if mode != "train" else None
        if self.kind == "K":
            return K.rwkv_block_apply(self.rwkv, x, cfg, self.ln1, self.ln2,
                                      cache=c)
        if self.kind == "R":
            h, c = self.rnn(self.ln1(x, cfg.norm, cfg.norm_eps), c)
            x = x + h
            h = self.ln2(x, cfg.norm, cfg.norm_eps)
            return x + self.ffn(h), c
        window = cfg.sliding_window if self.kind == "L" else None
        h = self.ln1(x, cfg.norm, cfg.norm_eps)
        q, k, v = self.attn.qkv(h, positions, run.attn_shard)
        sdt = getattr(torch, run.scores_dtype)
        if mode in ("train", "prefill"):
            o = L.blockwise_attention(
                q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
                q_chunk=run.q_chunk, kv_chunk=run.kv_chunk, scores_dtype=sdt)
            if mode == "prefill":
                cache = _write_prefill_cache(cache, k, v, window)
        else:
            cache = _write_decode_cache(cache, k, v, cache_len, window)
            cl = torch.as_tensor(cache_len, device=x.device) + 1
            if window is not None:
                cl = torch.clamp(cl, max=cache["k"].shape[1])
            o = L.decode_attention(q, cache["k"], cache["v"], cl,
                                   window=None, softcap=cfg.attn_softcap)
        x = x + self.attn.out(o, run.attn_shard)
        h = self.ln2(x, cfg.norm, cfg.norm_eps)
        return x + self.ffn(h), cache


def chunked_xent(h: torch.Tensor, labels, emb: torch.Tensor,
                 cfg: ModelConfig, loss_chunk: int) -> torch.Tensor:
    """Mean token xent of hidden states ``h`` against ``emb [D, V]`` over
    ``loss_chunk`` positions at a time, as the reference: labels padded
    with -1 to a whole chunk, float32 logits (softcapped, pad vocab at
    -1e30), logsumexp over the padded vocab, the target gathered at
    max(label, 0), terms with label < 0 dropped, the sum over max(count,
    1)."""
    B, S, D = h.shape
    labels = torch.as_tensor(labels, device=h.device).long()
    chunk = min(loss_chunk, S)
    n = (S + chunk - 1) // chunk
    pad = n * chunk - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    cap = cfg.logit_softcap
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n):
        hc = h[:, c * chunk:(c + 1) * chunk]
        lc = labels[:, c * chunk:(c + 1) * chunk]
        logits = linear_f32(hc, emb.to(hc.dtype))
        if cap:
            logits = torch.tanh(logits / cap) * cap
        logits = _mask_pad_logits(logits, cfg)
        logits = cns(logits, ("pod", "data"), None, "model")
        # each rank reduces, and reads the target from, its own shard of
        # the vocab
        lse = logsumexp(logits)
        valid = lc >= 0
        tgt = gather_last(logits, torch.clamp(lc, min=0))
        nll = (lse - tgt) * valid
        tot = tot + nll.sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


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
        gen = torch.Generator(device=L.init_device(self.device)).manual_seed(
            int(seed))
        L.init_(self, "embed_tok",
                lambda t: t.normal_(generator=gen).mul_(0.02))
        self.final_norm.init(gen)
        for blk in self.blocks:
            blk.init(gen)
        if self.lm_head is not None:
            L.init_(self, "lm_head",
                    lambda t: t.normal_(generator=gen).mul_(0.02))
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
        # F.embedding: its gradient sums repeated tokens in a fixed order
        # on the card (index_put_ with accumulation uses atomics).  Over a
        # mesh the table is gathered first: DTensor's rule for a vocab-
        # sharded table fails on batch-sharded ids (its mask has the local
        # ids' shape, the output the global one)
        x = F.embedding(torch.as_tensor(tokens, device=self.device).long(),
                        gathered(self.embed_tok)).to(cdt)
        if extra_embeds is not None:
            x = torch.cat([torch.as_tensor(extra_embeds, device=x.device)
                           .to(cdt), x], dim=1)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt,
                                 device=x.device)
        return cns(x, ("pod", "data"), None, None)

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
        if (mode == "train" and cache is None and torch.is_grad_enabled()
                and self.run.remat in ("block", "full")):
            n = self.n_full_cycles * len(self.pattern)
            for lo in range(0, n, len(self.pattern)):
                x = remat(self._train_blocks, x, lo, lo + len(self.pattern),
                          positions)
            x = self._train_blocks(x, n, len(self.blocks), positions)
        else:
            for i, blk in enumerate(self.blocks):
                c = None if cache is None else cache[i]
                x, c = blk(x, mode, c, cache_len, positions)
                if cache is not None:
                    cache[i] = c
        x = self.final_norm(x, self.cfg.norm, self.cfg.norm_eps)
        return x, cache

    def _train_blocks(self, x, lo: int, hi: int, positions):
        for blk in self.blocks[lo:hi]:
            x, _ = blk(x, "train", None, None, positions)
        return x

    def unembed(self) -> torch.Tensor:
        """``[D, padded_vocab]``: the embedding's transpose when tied."""
        if self.cfg.tie_embeddings:
            return self.embed_tok.t()
        return self.lm_head

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        cdt = hidden.dtype
        logits = linear(hidden, self.unembed().to(cdt))
        cap = self.cfg.logit_softcap
        if cap:
            logits = torch.tanh(logits / cap) * cap
        logits = _mask_pad_logits(logits, self.cfg)
        return cns(logits, ("pod", "data"), None, "model")

    # -- loss (chunked over sequence) ----------------------------------------
    def loss(self, tokens, labels, extra_embeds=None) -> torch.Tensor:
        """Mean next-token cross-entropy of a train-mode forward."""
        h, _ = self.hidden(tokens, extra_embeds, mode="train")
        return self.chunked_xent(h, labels)

    def chunked_xent(self, h: torch.Tensor, labels) -> torch.Tensor:
        return chunked_xent(h, labels, self.unembed(), self.cfg,
                            self.run.loss_chunk)

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

