"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
counterpart of ``repro/models/rglru.py``.

Block structure (the paper's "recurrent block"):
    x -> [branch A: linear -> gelu]                       (gate)
         [branch B: linear -> conv1d(w=4) -> RG-LRU]       (recurrence)
    out = wo(A * B)

RG-LRU per channel:
    r_t = sigmoid(W_a x_t)            (recurrence gate)
    i_t = sigmoid(W_x x_t)            (input gate)
    a_t = exp(c * softplus(Λ) * (-r_t))            # a in (0,1), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train and prefill scan the length axis in log2(S) rounds of elementwise
products (a Hillis-Steele doubling scan of the pairs (a, b) under
(a1, b1)·(a2, b2) = (a1·a2, a2·b1 + b2)); the reference's
``jax.lax.associative_scan`` combines the same pairs in another order, so
the two agree to float32 rounding, not bit for bit.  Decode is the
single-step recurrence with h carried in the cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.sharding import assign_, cns, linear, linear_f32

_C = 8.0


class RGLRU(nn.Module):
    """``rglru_init``: wx and wy ``[d, R]``, conv ``[W, R]``, gate_a and
    gate_x ``[R, R]``, a_param ``[R]``, wo ``[R, d]``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        r = cfg.rnn_width or cfg.d_model
        self.cfg = cfg
        self.wx = L.new_param(d, r, device=device)
        self.wy = L.new_param(d, r, device=device)
        self.conv = L.new_param(cfg.conv_width, r, device=device)
        self.gate_a = L.new_param(r, r, device=device)
        self.gate_x = L.new_param(r, r, device=device)
        self.a_param = L.new_param(r, device=device)
        self.wo = L.new_param(r, d, device=device)

    def init(self, gen: torch.Generator) -> None:
        """The reference's distributions: dense weights normal /
        sqrt(fan_in), conv normal · 0.02, a_param softplus⁻¹(-log(u) / c)
        for u uniform in [0.9, 0.999)."""
        for name in ("wx", "wy", "gate_a", "gate_x", "wo"):
            L.init_(self, name, lambda t: L.dense_init_(t, gen))
        L.init_(self, "conv", lambda t: t.normal_(generator=gen).mul_(0.02))

        def a_param(t):
            u = t.uniform_(0.9, 0.999, generator=gen)
            t.copy_(torch.log(torch.expm1(-torch.log(u) / _C)))
        L.init_(self, "a_param", a_param)

    def forward(self, x, cache=None):
        return rnn_block_apply(self, x, self.cfg, cache)


def _conv1d(x, w, state=None):
    """Causal depthwise conv.  x: [B, S, R]; w: [W, R]; state: [B, W-1, R].
    Returns (out, the last W-1 inputs)."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return out, new_state


def _gates(p: RGLRU, xb):
    """(a, sqrt(1 - a²)·i·x), float32 [B, S, R]."""
    rf = torch.sigmoid(linear_f32(xb, p.gate_a.to(xb.dtype)))
    i = torch.sigmoid(linear_f32(xb, p.gate_x.to(xb.dtype)))
    log_a = -_C * F.softplus(p.a_param.float()) * rf
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * xb.float()


def linear_scan(a, b):
    """h_t = a_t·h_{t-1} + b_t from h_0 = 0 along axis 1 of [B, S, ...]:
    ceil(log2 S) rounds, each combining every prefix with the one d steps
    before it."""
    S = a.shape[1]
    for r in range(math.ceil(math.log2(S)) if S > 1 else 0):
        d = 1 << r
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    return b


def rglru_scan(p: RGLRU, xb, h0=None):
    """xb: [B, S, R] conv output.  Returns (y [B,S,R], h_last [B,R] f32)."""
    a, bx = _gates(p, xb)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h0 + bx_1
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0.float()[:, None],
                        bx[:, 1:]], dim=1)
    h = linear_scan(a, bx)
    return h.to(xb.dtype), h[:, -1]


def rglru_step(p: RGLRU, xb, h):
    """Single decode step.  xb: [B, 1, R]; h: [B, R] f32."""
    a, bx = _gates(p, xb)
    h_new = a[:, 0] * h.float() + bx[:, 0]
    return h_new.to(xb.dtype)[:, None], h_new


def rnn_block_apply(p: RGLRU, x, cfg, cache=None):
    """Full recurrent block.  cache: None (train) or ``{"conv": [B, W-1,
    R], "h": [B, R]}``, written in place (conv in the cache's dtype, h in
    float32).  Returns (out, cache)."""
    cdt = x.dtype
    xb = linear(x, p.wx.to(cdt))
    gate = F.gelu(linear(x, p.wy.to(cdt)), approximate="tanh")
    xb = cns(xb, ("pod", "data"), None, "model")
    conv_state = None if cache is None else cache["conv"]
    xb, new_conv = _conv1d(xb, p.conv, conv_state)

    if cache is None:
        y, _ = rglru_scan(p, xb)
    else:
        if x.shape[1] == 1:
            y, h_last = rglru_step(p, xb, cache["h"])
        else:  # prefill with state
            y, h_last = rglru_scan(p, xb, h0=cache["h"])
        if new_conv is not None:
            assign_(cache["conv"], new_conv)
        assign_(cache["h"], h_last)
    out = linear(gate * y, p.wo.to(cdt))
    return cns(out, ("pod", "data"), None, None), cache


def rnn_cache_init(batch: int, cfg, dtype=torch.float32, device=None):
    r = cfg.rnn_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
    }
