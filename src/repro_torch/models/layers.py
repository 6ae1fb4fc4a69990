"""Transformer building blocks: norms, rope, GQA attention (blockwise
online-softmax for train/prefill, cached for decode), gated MLP.

Counterpart of ``repro/models/layers.py``.  The functions are plain
tensor code; :class:`Norm`, :class:`Attention` and :class:`MLP` hold the
weights with the reference's names and shapes (``x @ w``: ``wq`` is
``[d_model, heads · head_dim]``).  The compute dtype is the caller's
(the activations'); weights are float32 masters cast per matmul, and
softmax and normalisation statistics are float32, as in the reference.
Products whose reference asks for float32 results of low-precision
operands (``preferred_element_type``) take float32 copies of the
operands, so a bfloat16 run rounds where the reference does.

``seq_sharded_decode_attention`` (flash-decoding over a device mesh)
is ROADMAP.md A.13.2, and the reference's sharding constraints (``cns``)
are no-ops without a mesh, so the port has neither.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill w ``[..., fan_in, fan_out]`` with normal / sqrt(fan_in)."""
    fan_in = w.shape[-2] if w.dim() >= 2 else w.shape[0]
    with torch.no_grad():
        w.normal_(generator=gen).mul_(fan_in ** -0.5)
    return w


def new_param(*shape, device=None) -> nn.Parameter:
    """An uninitialised float32 parameter (no gradient: the port serves)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class Norm(nn.Module):
    """RMSNorm / LayerNorm scale (``norm_init``): ``scale [dim]``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = new_param(dim, device=device)

    def init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x, kind="rmsnorm", eps=1e-6):
        return norm_apply(self.scale, x, kind, eps)


def norm_apply(scale: torch.Tensor, x: torch.Tensor, kind="rmsnorm",
               eps=1e-6) -> torch.Tensor:
    """Normalise the last axis in float32 (layernorm's variance is the
    population variance, as ``jnp.var``) and cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable).  Rotates
    the two halves of Dh (not interleaved pairs) at float32 angles."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(s, cap: Optional[float]):
    if cap is None:
        return s
    return torch.tanh(s / cap) * cap


# ---------------------------------------------------------------------------
# blockwise attention (train / prefill): online softmax over kv chunks
# ---------------------------------------------------------------------------

def _pad_seq(x, chunk, axis):
    s = x.shape[axis]
    pad = (-s) % chunk
    if pad == 0:
        return x, s
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), s


def blockwise_attention(
    q: torch.Tensor,           # [B, Sq, H, Dh]
    k: torch.Tensor,           # [B, Skv, Hkv, Dh]
    v: torch.Tensor,           # [B, Skv, Hkv, Dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    q_offset: int = 0,         # global position of q[0] (prefill continuation)
    scores_dtype=torch.float32,
) -> torch.Tensor:
    """The reference's chunked online softmax, chunk for chunk: q chunks
    in turn, each over its kv chunks in the reference's scan order
    (ascending, or for a causal window the fixed range from the diagonal
    chunk down, clamped duplicates skipped), chunks wholly masked skipped,
    masked scores at NEG_INF, the output divided by max(l, 1e-30).  Memory
    stays one score block ``[B, Hkv, G, q_chunk, kv_chunk]`` at a time."""
    B, Sq0, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5

    q, Sq = _pad_seq(q, q_chunk, 1)
    k, Skv = _pad_seq(k, kv_chunk, 1)
    v, _ = _pad_seq(v, kv_chunk, 1)
    nq = q.shape[1] // q_chunk
    nk = k.shape[1] // kv_chunk

    qb = (q.reshape(B, nq, q_chunk, Hkv, G, Dh) * scale).to(q.dtype)
    kb = k.reshape(B, nk, kv_chunk, Hkv, Dh)
    vb = v.reshape(B, nk, kv_chunk, Hkv, Dh)
    dev = q.device
    q_pos0 = torch.arange(q_chunk, device=dev)
    k_pos0 = torch.arange(kv_chunk, device=dev)

    # windowed attention only needs kv chunks within [q - window, q]
    nk_eff = nk
    if window is not None and causal:
        nk_eff = min(nk, (window + q_chunk) // kv_chunk + 2)

    outs = []
    for qi in range(nq):
        qblk = qb[:, qi]                           # [B, qc, Hkv, G, Dh]
        q_pos = q_offset + qi * q_chunk + q_pos0
        last_q = q_offset + qi * q_chunk + (q_chunk - 1)
        first_q = q_offset + qi * q_chunk
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Hkv, G, q_chunk, Dh), dtype=torch.float32,
                        device=dev)
        for rel in range(nk_eff):
            if nk_eff != nk:
                raw = qi + (q_offset // kv_chunk) - rel
                ki = max(raw, 0)
                needed = raw >= 0                 # clamped duplicates skip
            else:
                ki = rel
                needed = True
            if causal:
                needed = needed and ki * kv_chunk <= last_q
            if window is not None:
                needed = needed and (ki * kv_chunk + kv_chunk - 1
                                     >= first_q - window)
            if not needed:
                continue
            k_pos = ki * kv_chunk + k_pos0
            kblk, vblk = kb[:, ki], vb[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk.to(scores_dtype),
                             kblk.to(scores_dtype)).float()
            s = _softcap(s, softcap)
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            else:
                mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                                  device=dev)
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            mask = mask & (k_pos[None, :] < Skv)
            s = torch.where(mask[None, None, None], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(),
                              vblk.float())
            o = o * corr[..., None] + pv
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)
        # [B, Hkv, G, qc, Dh] -> [B, qc, Hkv*G, Dh]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, Dh)
                    .to(q.dtype))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq0]


# ---------------------------------------------------------------------------
# decode attention (single new token against a cache)
# ---------------------------------------------------------------------------

def decode_attention(
    q: torch.Tensor,           # [B, 1, H, Dh]
    k_cache: torch.Tensor,     # [B, S, Hkv, Dh]
    v_cache: torch.Tensor,
    cache_len,                 # int, [] or [B] valid prefix length (new token incl.)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    qg = q.reshape(B, Hkv, G, Dh) * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None] if cl.dim() == 1 else cl.reshape(1, 1)
    valid = pos[None, :] < cl                      # [B or 1, S]
    if window is not None:
        valid = valid & (pos[None, :] >= cl - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections (``attn_init``): wq ``[d, H·Dh]``, wk and wv ``[d,
    Hkv·Dh]``, wo ``[H·Dh, d]``, and with ``qk_norm`` q_ln / k_ln over Dh."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        dh = cfg.resolved_head_dim()
        self.cfg = cfg
        self.wq = new_param(d, h * dh, device=device)
        self.wk = new_param(d, hkv * dh, device=device)
        self.wv = new_param(d, hkv * dh, device=device)
        self.wo = new_param(h * dh, d, device=device)
        if cfg.qk_norm:
            self.q_ln = Norm(dh, device)
            self.k_ln = Norm(dh, device)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, gen)
        if self.cfg.qk_norm:
            self.q_ln.init(gen)
            self.k_ln.init(gen)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Project + rope.  x: [B, S, D] -> q [B,S,H,Dh], k/v [B,S,Hkv,Dh]."""
        cfg = self.cfg
        B, S, _ = x.shape
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
        cdt = x.dtype
        q = (x @ self.wq.to(cdt)).reshape(B, S, h, dh)
        k = (x @ self.wk.to(cdt)).reshape(B, S, hkv, dh)
        v = (x @ self.wv.to(cdt)).reshape(B, S, hkv, dh)
        if cfg.qk_norm:
            q = self.q_ln(q, cfg.norm, cfg.norm_eps)
            k = self.k_ln(k, cfg.norm, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        B, S, h, dh = o.shape
        return o.reshape(B, S, h * dh) @ self.wo.to(o.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(x, kind):
    # jax.nn.gelu's default is the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """``mlp_init``: wi ``[d, f]``, wo ``[f, d]`` and, gated, wg ``[d, f]``."""

    def __init__(self, cfg, gated: Optional[bool] = None, device=None):
        super().__init__()
        gated = cfg.mlp_gated if gated is None else gated
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.act
        self.wi = new_param(d, f, device=device)
        self.wo = new_param(f, d, device=device)
        self.wg = new_param(d, f, device=device) if gated else None

    def init(self, gen: torch.Generator) -> None:
        for w in (self.wi, self.wo, self.wg):
            if w is not None:
                dense_init_(w, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = x.dtype
        hi = x @ self.wi.to(cdt)
        if self.wg is not None:
            hi = _act(x @ self.wg.to(cdt), self.act) * hi
        else:
            hi = _act(hi, self.act)
        return hi @ self.wo.to(cdt)
