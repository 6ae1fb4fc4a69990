"""Encoder-decoder transformer (whisper-style) sharing the layer toolbox —
counterpart of ``repro/models/encdec.py``.

The audio conv frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings ``enc_frames [B, S_enc, D]`` (what the two
conv layers would emit).  Encoder = bidirectional self-attention blocks;
decoder = causal self-attention + cross-attention + MLP.  Sinusoidal
positions throughout (and the attention's rope, as in the reference).

The reference stacks each layer's leaves (``encoder/<leaf> [L, ...]``,
``decoder/<leaf>``) and scans; here the layers are ``ModuleList``s, layer
l being the stacked leaves' entry l (``model_zoo.load_params``).  A cache
is ``{"dec": [{"k", "v"} a decoder layer], "xkv": None}`` until prefill
fills ``xkv`` with each layer's cross-attention ``{"k", "v"} [B, S_enc,
H, Dh]``, computed once and carried; the decoder's self-attention is MHA
(``num_heads``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import (cns, gathered, heads_in,
                                         heads_out, linear, remat)
from repro_torch.models.transformer import (_mask_pad_logits,
                                            _write_decode_cache,
                                            _write_prefill_cache,
                                            chunked_xent, padded_vocab)


def sinusoidal(positions: torch.Tensor, d_model: int, dtype) -> torch.Tensor:
    """[..., d_model]: sin then cos of position · 10000^(-i / max(half - 1,
    1)) for i < half, float32 angles."""
    half = d_model // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-math.log(10000.0) * i / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


class CrossAttention(nn.Module):
    """``xattn_init``: wq, wk, wv ``[d, H·Dh]``, wo ``[H·Dh, d]``; split by
    whole heads over a model axis that the heads do not divide."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim()
        self.num_heads = h
        self.wq = L.new_param(d, h * dh, device=device)
        self.wk = L.new_param(d, h * dh, device=device)
        self.wv = L.new_param(d, h * dh, device=device)
        self.wo = L.new_param(h * dh, d, device=device)

    def init(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            L.init_(self, name, lambda t: L.dense_init_(t, gen))

    def head_leaves(self) -> dict:
        """``{weight: (its flat heads dim, heads)}`` (``sharding.
        leaf_heads``): every head has its own k and v."""
        h = self.num_heads
        return {"wq": (1, h), "wk": (1, h), "wv": (1, h), "wo": (0, h)}


class EncBlock(nn.Module):
    """``_enc_block_init``: ln1, attn, ln2, mlp."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg.d_model, device)
        self.mlp = L.MLP(cfg, gated=cfg.mlp_gated, device=device)

    def init(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init(gen)


class DecBlock(nn.Module):
    """``_dec_block_init``: ln1, attn, ln_x, cross, ln2, mlp."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ln_x = L.Norm(cfg.d_model, device)
        self.cross = CrossAttention(cfg, device)
        self.ln2 = L.Norm(cfg.d_model, device)
        self.mlp = L.MLP(cfg, gated=cfg.mlp_gated, device=device)

    def init(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init(gen)


class EncDecLM(nn.Module):
    """The encoder-decoder: ``embed_tok [padded_vocab, d_model]`` (tied
    unembedding), ``encoder``, ``enc_norm``, ``decoder``, ``final_norm``;
    float32 parameters on ``device``, uninitialised until :meth:`init` or
    ``model_zoo.load_params``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig = RunConfig(),
                 device=None):
        super().__init__()
        self.cfg, self.run = cfg, run
        self.embed_tok = L.new_param(padded_vocab(cfg), cfg.d_model,
                                     device=device)
        self.encoder = nn.ModuleList(EncBlock(cfg, device)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = L.Norm(cfg.d_model, device)
        self.decoder = nn.ModuleList(DecBlock(cfg, device)
                                     for _ in range(cfg.num_layers))
        self.final_norm = L.Norm(cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed_tok.device

    def init(self, seed: int = 0) -> "EncDecLM":
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed`` (the reference's distributions; other values than its
        ``init``).  Returns the model."""
        gen = torch.Generator(device=L.init_device(self.device)).manual_seed(
            int(seed))
        L.init_(self, "embed_tok",
                lambda t: t.normal_(generator=gen).mul_(0.02))
        for m in (*self.encoder, self.enc_norm, *self.decoder,
                  self.final_norm):
            m.init(gen)
        return self

    def _cdt(self):
        return getattr(torch, self.run.compute_dtype)

    def _remat(self) -> bool:
        return (torch.is_grad_enabled()
                and self.run.remat in ("block", "full"))

    # -- encoder -----------------------------------------------------------
    def _enc_body(self, blk: EncBlock, x, positions):
        cfg, run = self.cfg, self.run
        h = blk.ln1(x, cfg.norm, cfg.norm_eps)
        q, k, v = blk.attn.qkv(h, positions, run.attn_shard)
        o = L.blockwise_attention(q, k, v, causal=False, q_chunk=run.q_chunk,
                                  kv_chunk=run.kv_chunk)
        x = x + blk.attn.out(o, run.attn_shard)
        h = blk.ln2(x, cfg.norm, cfg.norm_eps)
        return x + blk.mlp(h)

    def encode(self, frames) -> torch.Tensor:
        """frames: [B, Se, D] precomputed conv-frontend output (stub).
        Each layer is a checkpoint region under ``run.remat`` "block" or
        "full" when gradients are on, as the reference's."""
        cfg = self.cfg
        cdt = self._cdt()
        x = torch.as_tensor(frames, device=self.device).to(cdt)
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoidal(pos, cfg.d_model, cdt)[None]
        x = cns(x, ("pod", "data"), None, None)
        positions = pos[None, :]
        for blk in self.encoder:
            if self._remat():
                x = remat(self._enc_body, blk, x, positions)
            else:
                x = self._enc_body(blk, x, positions)
        return self.enc_norm(x, cfg.norm, cfg.norm_eps)

    def _cross_kv(self, enc_out) -> list:
        """Each decoder layer's cross-attention ``{"k", "v"}`` ``[B, Se, H,
        Dh]``."""
        cfg = self.cfg
        h, dh = cfg.num_heads, cfg.resolved_head_dim()
        dt = enc_out.dtype
        return [{"k": heads_in(enc_out, blk.cross.wk, h, dh),
                 "v": heads_in(enc_out, blk.cross.wv, h, dh)}
                for blk in self.decoder]

    # -- decoder -----------------------------------------------------------
    def _dec_body(self, blk: DecBlock, x, xk, xv, mode, c, cache_len,
                  positions):
        cfg, run = self.cfg, self.run
        h = blk.ln1(x, cfg.norm, cfg.norm_eps)
        q, k, v = blk.attn.qkv(h, positions, run.attn_shard)
        if mode in ("train", "prefill"):
            o = L.blockwise_attention(q, k, v, causal=True,
                                      q_chunk=run.q_chunk,
                                      kv_chunk=run.kv_chunk)
            if mode == "prefill":
                c = _write_prefill_cache(c, k, v, None)
        else:
            c = _write_decode_cache(c, k, v, cache_len, None)
            o = L.decode_attention(q, c["k"], c["v"],
                                   torch.as_tensor(cache_len,
                                                   device=x.device) + 1)
        x = x + blk.attn.out(o, run.attn_shard)
        h = blk.ln_x(x, cfg.norm, cfg.norm_eps)
        hq, dh = cfg.num_heads, cfg.resolved_head_dim()
        cq = heads_in(h, blk.cross.wq, hq, dh)
        cq = cns(cq, None, None, "model", None)
        o = L.blockwise_attention(cq, xk, xv, causal=False, softcap=None,
                                  q_chunk=run.q_chunk, kv_chunk=run.kv_chunk)
        x = x + heads_out(o, blk.cross.wo)
        h = blk.ln2(x, cfg.norm, cfg.norm_eps)
        return x + blk.mlp(h), c

    def _dec_train_body(self, blk, x, xk, xv, positions):
        return self._dec_body(blk, x, xk, xv, "train", None, None,
                              positions)[0]

    def _dec_forward(self, tokens, xkv, mode, cache, cache_len):
        """Final-normed decoder states and the cache (``{"dec": [...]}``
        written in place; None in train)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode}")
        cfg = self.cfg
        cdt = self._cdt()
        tok = torch.as_tensor(tokens, device=self.device).long()
        x = F.embedding(tok, gathered(self.embed_tok)).to(cdt)  # LM._embed
        B, S = x.shape[0], x.shape[1]
        if mode == "decode":
            positions = torch.as_tensor(cache_len, device=x.device).to(
                torch.int32).expand(B)[:, None]                   # [B, 1]
        else:
            positions = torch.arange(S, device=x.device)[None, :]
        x = x + sinusoidal(positions, cfg.d_model, cdt)
        x = cns(x, ("pod", "data"), None, None)
        for i, blk in enumerate(self.decoder):
            xk, xv = xkv[i]["k"], xkv[i]["v"]
            if mode == "train":
                if self._remat():
                    x = remat(self._dec_train_body, blk, x, xk, xv,
                              positions)
                else:
                    x = self._dec_train_body(blk, x, xk, xv, positions)
                continue
            x, cache["dec"][i] = self._dec_body(
                blk, x, xk, xv, mode, cache["dec"][i], cache_len, positions)
        return self.final_norm(x, cfg.norm, cfg.norm_eps), cache

    # -- public API ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        hkv, dh = cfg.num_heads, cfg.resolved_head_dim()   # decoder is MHA

        def kv():
            return torch.zeros((batch, max_len, hkv, dh), dtype=dtype,
                               device=self.device)
        return {"dec": [{"k": kv(), "v": kv()} for _ in self.decoder],
                "xkv": None}

    def loss(self, tokens, labels, enc_frames) -> torch.Tensor:
        enc = self.encode(enc_frames)
        xkv = self._cross_kv(enc)
        h, _ = self._dec_forward(tokens, xkv, "train", None, None)
        return chunked_xent(h, labels, self.embed_tok.t(), self.cfg,
                            self.run.loss_chunk)

    def prefill(self, tokens, cache, enc_frames):
        """Returns (cache with ``xkv``, last_position_logits ``[B, 1,
        V]``)."""
        enc = self.encode(enc_frames)
        xkv = self._cross_kv(enc)
        h, cache = self._dec_forward(tokens, xkv, "prefill", cache, None)
        cache["xkv"] = xkv
        return cache, self._logits(h[:, -1:])

    def decode_step(self, token, cache, cache_len):
        """token: [B, 1] -> (cache, logits [B, 1, V])."""
        h, cache = self._dec_forward(token, cache["xkv"], "decode", cache,
                                     cache_len)
        return cache, self._logits(h)

    def _logits(self, h) -> torch.Tensor:
        logits = linear(h, self.embed_tok.t().to(h.dtype))
        logits = _mask_pad_logits(logits, self.cfg)
        return cns(logits, ("pod", "data"), None, "model")
