"""RWKV6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
data-dependent per-channel decay, plus the squared-ReLU channel mix —
counterpart of ``repro/models/rwkv6.py``.

Time mix (per head, Dk = Dv = head size):
    state_t = diag(w_t) state_{t-1} + k_t^T v_t          [Dk, Dv]
    out_t   = r_t (state_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + lora_w(x_t))) in (0,1) data-dependent.

Train and prefill loop over time, one step at a time as the reference's
``lax.scan``; decode is the single step.  Under autograd every step keeps
its ``[B, H, 64, 64]`` float32 state, so a long full-width train step
holds S of them a layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.sharding import (assign_, batch_heads, cns,
                                         contiguous_stride, head_chunk,
                                         is_dtensor, linear, linear_f32,
                                         matmul, merge_heads, moved,
                                         shard_box, split_heads, spread,
                                         whole_heads_dim)

LORA_RANK = 32


def rwkv_head_dim(cfg) -> int:
    return 64


class TimeMix(nn.Module):
    """``rwkv_init``'s ``tmix``: mix ``[5, d]`` (r, k, v, g, w), wr, wk,
    wv, wg and wo ``[d, d]``, w_decay and u ``[H, 64]``, decay_lora_a
    ``[d, 32]``, decay_lora_b ``[32, d]``, ln_out."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        dh = rwkv_head_dim(cfg)
        h = d // dh
        self.mix = L.new_param(5, d, device=device)
        self.wr = L.new_param(d, d, device=device)
        self.wk = L.new_param(d, d, device=device)
        self.wv = L.new_param(d, d, device=device)
        self.wg = L.new_param(d, d, device=device)
        self.w_decay = L.new_param(h, dh, device=device)
        self.decay_lora_a = L.new_param(d, LORA_RANK, device=device)
        self.decay_lora_b = L.new_param(LORA_RANK, d, device=device)
        self.u = L.new_param(h, dh, device=device)
        self.ln_out = L.Norm(d, device)
        self.wo = L.new_param(d, d, device=device)

    def init(self, gen: torch.Generator) -> None:
        """The reference's distributions: mix uniform in [0, 1), w_decay
        -2 + normal · 0.1, decay_lora_b dense · 0.1, u normal · 0.5."""
        for name in ("wr", "wk", "wv", "wg", "decay_lora_a"):
            L.init_(self, name, lambda t: L.dense_init_(t, gen))
        # its scale draws nothing: taken at once, the draws keep their order
        L.init_(self, "decay_lora_b",
                lambda t: L.dense_init_(t, gen).mul_(0.1))
        L.init_(self, "wo", lambda t: L.dense_init_(t, gen))
        L.init_(self, "mix", lambda t: t.uniform_(0.0, 1.0, generator=gen))
        L.init_(self, "w_decay",
                lambda t: t.normal_(generator=gen).mul_(0.1).add_(-2.0))
        L.init_(self, "u", lambda t: t.normal_(generator=gen).mul_(0.5))
        self.ln_out.init(gen)


class ChannelMix(nn.Module):
    """``rwkv_init``'s ``cmix``: mix ``[2, d]`` (k, r), wk ``[d, f]``, wv
    ``[f, d]``, wr ``[d, d]``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        self.mix = L.new_param(2, d, device=device)
        self.wk = L.new_param(d, cfg.d_ff, device=device)
        self.wv = L.new_param(cfg.d_ff, d, device=device)
        self.wr = L.new_param(d, d, device=device)

    def init(self, gen: torch.Generator) -> None:
        for name in ("wk", "wv", "wr"):
            L.init_(self, name, lambda t: L.dense_init_(t, gen))
        L.init_(self, "mix", lambda t: t.uniform_(0.0, 1.0, generator=gen))


class RWKV(nn.Module):
    """``{"tmix", "cmix"}``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.tmix = TimeMix(cfg, device)
        self.cmix = ChannelMix(cfg, device)

    def init(self, gen: torch.Generator) -> None:
        self.tmix.init(gen)
        self.cmix.init(gen)


def _cols_as(w, ref):
    """``w`` ``[d, n]``, which the rules replicate (``wr``), split over the
    mesh as ``ref``'s columns are (a local slice, nothing moves): each
    rank computes only the heads or channels its consumer holds, as GSPMD
    partitions a product whose result is consumed split.  ``w`` itself
    off a mesh."""
    if not is_dtensor(w) or not is_dtensor(ref):
        return w
    from torch.distributed.tensor import Replicate

    return moved(w, [p if p.is_shard(1) else Replicate()
                     for p in ref.placements])


def _contraction_as(x, ref):
    """``x [..., d]``, whole on the mesh dims that split ``ref``'s columns
    (``wk``), split there along its last dim (a local slice, nothing
    moves): a product with a replicated weight (``decay_lora_a``) then
    runs on each rank's slice of the contraction and gives a partial sum,
    where every rank of the axis would compute the whole product.  ``x``
    itself off a mesh."""
    if not is_dtensor(x) or not is_dtensor(ref):
        return x
    from torch.distributed.tensor import Shard

    last = x.dim() - 1
    return moved(x, [Shard(last) if q.is_shard(1) and p.is_replicate()
                     else p for p, q in zip(x.placements, ref.placements)])


def _token_shift(x, last):
    """previous token's activation; last: [B, 1, D] carried state."""
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _tm_inputs(p: TimeMix, x, prev):
    xx = prev - x
    mix = p.mix.to(x.dtype)
    return tuple(x + xx * mix[i] for i in range(5))   # xr, xk, xv, xg, xw


def time_mix(p: TimeMix, x, cfg, cache=None):
    """x: [B, S, D]; cache: ``{"shift": [B,1,D], "state": [B,H,Dk,Dv]}``
    or None.  Returns (out, new cache); a given cache is written in place
    (shift in its dtype, state float32)."""
    B, S, D = x.shape
    dh = rwkv_head_dim(cfg)
    H = D // dh
    cdt = x.dtype
    last = x.new_zeros((B, 1, D)) if cache is None else cache["shift"]
    prev = _token_shift(x, last)
    xr, xk, xv, xg, xw = _tm_inputs(p, x, prev)

    r = split_heads(linear(xr, _cols_as(p.wr, p.wk).to(cdt)), H, dh)
    k = split_heads(linear(xk, p.wk.to(cdt)), H, dh)
    v = split_heads(linear(xv, p.wv.to(cdt)), H, dh)
    g = F.silu(linear(xg, p.wg.to(cdt)))
    lora = linear_f32(torch.tanh(linear(_contraction_as(xw, p.wk),
                                        p.decay_lora_a.to(cdt))),
                      _cols_as(p.decay_lora_b, p.wk).to(cdt))
    w = torch.exp(-torch.exp(
        (p.w_decay.reshape(1, 1, H, dh) + split_heads(lora, H, dh))
        .float()))                                               # [B,S,H,dh]
    state = None if cache is None else cache["state"]
    out, state = wkv(r, k, v, w, p.u.float(), state)
    out = out.to(cdt)

    out = p.ln_out(out, "rmsnorm", cfg.norm_eps) * g
    out = cns(linear(out, p.wo.to(cdt)), ("pod", "data"), None, None)
    if cache is None:
        return out, {"shift": x[:, -1:], "state": state}
    assign_(cache["shift"], x[:, -1:])
    assign_(cache["state"], state)
    return out, cache


def _wkv_loop(r, k, v, w, u, state):
    """The recurrence on plain tensors: r, k, w ``[B, S, H, dh]``, v
    ``[B, S, H, dv]`` (dv = dh, or a slice of the value columns), u
    ``[H, dh]``, state ``[B, H, dh, dv]`` or None (zeros).  Returns
    (out ``[B, S, H, dh]``, the last state), float32."""
    B, S, H, dh = r.shape
    rf, kf, vf, w = r.float(), k.float(), v.float(), w.float()
    u = u[None, :, :, None]
    state = (rf.new_zeros((B, H, dh, vf.shape[-1])) if state is None
             else state.float())
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # [B,H,dk,dv]
        # [B, H, 1, dk] @ [B, H, dk, dv] (a matmul: layers.py's docstring)
        outs.append(matmul(rf[:, t, :, None], state + u * kv)[:, :, 0])
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv(r, k, v, w, u, state=None):
    """:func:`_wkv_loop`, its output merged to ``[B, S, H·dv]``; over a
    mesh each rank loops over its own batch rows and heads
    (``sharding.batch_heads``), its slice of the replicated ``u`` taken
    locally (its gradient a partial sum over the ranks), and the results
    are DTensors placed as that split.  Where the heads do not divide the
    model axis (they stay whole there: ``sharding.split_heads``) and the
    axis's ranks are a multiple of the heads, each rank takes one head's
    slice of the value columns there (a state column depends on its value
    column only, so no rank repeats another's work): its block of the
    merged output is the rank's block of an even split of the flat dim,
    and the output is that split, as the heads' output is where they
    divide the axis.  Otherwise each rank loops over ``head_chunk``'s
    heads (``ceil(H / ranks)``, as GSPMD pads them), and the output is a
    partial sum there, each rank's block in its place (``sharding.
    spread``).  The state is such a partial sum in both cases: a rank's
    block of it is no DTensor split."""
    if not is_dtensor(r):
        out, state = _wkv_loop(r, k, v, w, u, state)
        return merge_heads(out), state
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = r.device_mesh
    pl = batch_heads(r)
    spl = [Shard(1) if p.is_shard(2) else p for p in pl]   # [B, H, ...]
    r, k, v, w = (moved(t, pl, mesh) for t in (r, k, v, w))
    pad = whole_heads_dim(r)
    B, S, H, dh = r.shape
    per = 0
    if pad is not None and mesh.size(pad) % H == 0 \
            and dh % (mesh.size(pad) // H) == 0:
        per = mesh.size(pad) // H
    g = [Partial() if d == pad else p for d, p in enumerate(pl)]
    rl, kl, vl, wl = (t.to_local(grad_placements=g) for t in (r, k, v, w))
    h0, hl = shard_box(r)[0][2], rl.shape[2]
    d0, dl = 0, dh
    if state is not None:
        state = moved(state, spl, mesh).to_local()
    if per:                             # one head's value columns
        i = mesh.get_coordinate()[pad]
        h0, hl, dl = i // per, 1, dh // per
        d0 = (i % per) * dl
        vl = vl[:, :, h0:h0 + 1, d0:d0 + dl]
    elif pad is not None:               # head_chunk's heads
        h0, hl = head_chunk(H, mesh, pad)
        vl = vl[:, :, h0:h0 + hl]
    if pad is not None:
        rl, kl, wl = (t[:, :, h0:h0 + hl] for t in (rl, kl, wl))
        if state is not None:
            state = state[:, h0:h0 + hl, :, d0:d0 + dl]
    ul = u.to_local(grad_placements=[
        Partial() if p.is_shard() or d == pad else Replicate()
        for d, p in enumerate(pl)])[h0:h0 + hl]
    out, state = _wkv_loop(rl, kl, vl, wl, ul, state)
    if pad is None:
        return (merge_heads(DTensor.from_local(out, mesh, pl,
                                               run_check=False)),
                DTensor.from_local(state, mesh, spl, run_check=False))
    state = spread(state, {1: (h0, H), 3: (d0, dh)}, mesh, spl, pad)
    if not per:
        return merge_heads(spread(out, {2: (h0, H)}, mesh, pl, pad)), state
    fpl = list(pl)
    fpl[pad] = Shard(2)
    shape = (B, S, H * dh)
    return (DTensor.from_local(out.reshape(*out.shape[:2], dl), mesh, fpl,
                               run_check=False, shape=torch.Size(shape),
                               stride=contiguous_stride(shape)), state)


def channel_mix(p: ChannelMix, x, cfg, cache=None):
    """Returns (out, new cache ``{"shift"}``); a given cache is written in
    place."""
    B, S, D = x.shape
    cdt = x.dtype
    last = x.new_zeros((B, 1, D)) if cache is None else cache["shift"]
    prev = _token_shift(x, last)
    xx = prev - x
    mix = p.mix.to(cdt)
    xk = x + xx * mix[0]
    xr = x + xx * mix[1]
    k = torch.square(torch.relu(linear(xk, p.wk.to(cdt))))
    k = cns(k, ("pod", "data"), None, "model")
    r = torch.sigmoid(linear(xr, _cols_as(p.wr, p.wk).to(cdt)))
    out = cns(r * linear(k, p.wv.to(cdt)), ("pod", "data"), None, None)
    if cache is None:
        return out, {"shift": x[:, -1:]}
    assign_(cache["shift"], x[:, -1:])
    return out, cache


def rwkv_block_apply(p: RWKV, x, cfg, ln1, ln2, cache=None):
    """Full RWKV block: x + TimeMix(ln1(x)); x + ChannelMix(ln2(x)).
    Returns (x, cache): the given cache written in place, or without one
    a new cache, as the reference returns one in train mode too."""
    tc = None if cache is None else cache["tmix"]
    cc = None if cache is None else cache["cmix"]
    h, new_tc = time_mix(p.tmix, ln1(x, cfg.norm, cfg.norm_eps), cfg, tc)
    x = x + h
    h, new_cc = channel_mix(p.cmix, ln2(x, cfg.norm, cfg.norm_eps), cfg, cc)
    x = x + h
    return x, {"tmix": new_tc, "cmix": new_cc}


def rwkv_cache_init(batch: int, cfg, dtype=torch.bfloat16, device=None):
    d = cfg.d_model
    dh = rwkv_head_dim(cfg)
    h = d // dh
    return {
        "tmix": {"shift": torch.zeros((batch, 1, d), dtype=dtype,
                                      device=device),
                 "state": torch.zeros((batch, h, dh, dh),
                                      dtype=torch.float32, device=device)},
        "cmix": {"shift": torch.zeros((batch, 1, d), dtype=dtype,
                                      device=device)},
    }
