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
operands, so a bfloat16 run rounds where the reference does.  The
attention products are matmuls where the reference has einsums: over a
mesh DTensor caches the sharding of a matmul's ops, and propagates an
einsum's afresh at every call.

The reference's sharding constraints stand where it has them
(``sharding.cns``): over a device mesh the activations are DTensors and
``cns`` redistributes them; without one it returns its input.  Over a
mesh the projections are ``sharding.linear`` on each rank's share (by
whole heads where the heads do not divide the model axis:
``sharding.heads_in``, ``heads_out``), and attention, train, prefill and
decode alike, runs on each rank's batch rows and query heads, a rank
slicing out the kv heads its query heads use where the kv heads are not
split as the query heads are.
:func:`seq_sharded_decode_attention` is the reference's flash-decoding over
a KV cache sharded along the sequence, merged with collectives over the
sequence axis's process group; the reference defines it and calls it
nowhere, and so does the port.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.models.sharding import (batch_heads, cns,
                                         contiguous_stride, head_chunk,
                                         heads_in, heads_of, heads_out,
                                         is_dtensor, like, linear, matmul,
                                         merge_heads, moved, shard_box,
                                         split_heads, spread,
                                         whole_heads_dim)

NEG_INF = -1e30


def exact_matmuls() -> None:
    """Make the card's products compute as the reference's dots do: a
    float32 product in float32 (no TF32, in cuBLAS or cuDNN), and a
    bfloat16 product summing its partial products in float32 (cuBLAS may
    otherwise split K and add the partial sums in bfloat16).  The CLIs
    and the smoke set the numerics here, and only here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill w ``[..., fan_in, fan_out]`` with normal / sqrt(fan_in)."""
    fan_in = w.shape[-2] if w.dim() >= 2 else w.shape[0]
    with torch.no_grad():
        w.normal_(generator=gen).mul_(fan_in ** -0.5)
    return w


_FILL: ContextVar[Optional[tuple]] = ContextVar("init_fill", default=None)


def init_(module: nn.Module, name: str, fill) -> None:
    """Initialise ``module``'s parameter ``name`` by ``fill(tensor)``, which
    fills it in place (the modules' ``init(gen)`` call this once a
    parameter, in the order they draw from ``gen``).  Under
    :func:`leaf_by_leaf` the context's hook makes the leaf instead."""
    ctx = _FILL.get()
    if ctx is not None:
        ctx[0](module, name, fill)
        return
    with torch.no_grad():
        fill(module._parameters[name])


@contextlib.contextmanager
def leaf_by_leaf(hook, device):
    """Run ``init`` with every :func:`init_` handed to ``hook(module, name,
    fill)``, and the model's generator on ``device``
    (:func:`init_device`): a model on the meta device is then initialised
    one leaf at a time (``model_zoo.init_on_mesh``)."""
    tok = _FILL.set((hook, device))
    try:
        yield
    finally:
        _FILL.reset(tok)


def init_device(default):
    """The device of the generator ``init`` draws from: the one
    :func:`leaf_by_leaf` names, else ``default`` (the model's)."""
    ctx = _FILL.get()
    return default if ctx is None else ctx[1]


def new_param(*shape, device=None) -> nn.Parameter:
    """An uninitialised float32 parameter, without gradients until the
    train step turns them on (``train_step.build_train_step``)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class Norm(nn.Module):
    """RMSNorm / LayerNorm scale (``norm_init``): ``scale [dim]``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = new_param(dim, device=device)

    def init(self, gen: torch.Generator) -> None:
        init_(self, "scale", lambda t: t.fill_(1.0))

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


SCORE_BLOCK = 1 << 21   # rows x columns of a head's scores at once


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
    """The reference's chunked online softmax: each q chunk over its kv
    chunks in the reference's scan order (ascending, or for a causal
    window the fixed range from the diagonal chunk down, clamped
    duplicates skipped), chunks wholly masked skipped, masked scores at
    NEG_INF, the output divided by max(l, 1e-30).  Without a window the
    q chunks that read a kv chunk read it together (:func:`_by_kv_chunk`),
    each in its own order still, so that a layer dispatches its ops once
    a kv chunk and not once a pair of chunks; a score block then holds at
    most SCORE_BLOCK rows x columns a head.  With a window one score block
    ``[B, Hkv, G, q_chunk, kv_chunk]`` at a time (:func:`_by_pair`)."""
    if is_dtensor(q):
        return _blockwise_attention_on_shards(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset,
            scores_dtype=scores_dtype)
    B, Sq0, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv if Hkv else 0        # a rank without heads
    scale = Dh ** -0.5

    q, Sq = _pad_seq(q, q_chunk, 1)
    k, Skv = _pad_seq(k, kv_chunk, 1)
    v, _ = _pad_seq(v, kv_chunk, 1)
    nq = q.shape[1] // q_chunk
    nk = k.shape[1] // kv_chunk

    qb = (q.reshape(B, nq, q_chunk, Hkv, G, Dh) * scale).to(q.dtype)
    kb = k.reshape(B, nk, kv_chunk, Hkv, Dh)
    vb = v.reshape(B, nk, kv_chunk, Hkv, Dh)
    kw = dict(causal=causal, softcap=softcap, q_offset=q_offset, Skv=Skv,
              scores_dtype=scores_dtype)
    if window is None:
        out = _by_kv_chunk(qb, kb, vb, **kw)
    else:
        out = _by_pair(qb, kb, vb, window=window, **kw)
    return out.reshape(B, nq * q_chunk, H, Dh).to(q.dtype)[:, :Sq0]


def _online_step(s, vblk, m, l, o):
    """One kv chunk into the softmax state of the rows of ``s`` (masked
    scores ``[B, Hkv, G, rows, kv_chunk]``): the reference's update."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    # [B, Hkv, G, rows, kc] @ [B, Hkv, 1, kc, Dh]
    pv = matmul(p.to(vblk.dtype).float(),
                vblk.float().permute(0, 2, 1, 3)[:, :, None])
    return m_new, l, o * corr[..., None] + pv


def _scores(qrows, kblk, k_pos, q_pos, *, causal, softcap, Skv,
            scores_dtype, window=None):
    """Masked scores of query rows ``[B, Hkv, G, rows, Dh]`` (at
    positions ``q_pos``) against one kv chunk (at ``k_pos``)."""
    # [B, Hkv, G, rows, Dh] @ [B, Hkv, 1, Dh, kc]
    s = matmul(qrows.to(scores_dtype),
               kblk.to(scores_dtype).permute(0, 2, 3, 1)[:, :, None]).float()
    s = _softcap(s, softcap)
    mask = k_pos[None, :] < Skv
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))


def _by_kv_chunk(qb, kb, vb, *, causal, softcap, q_offset, Skv,
                 scores_dtype):
    """Attention without a window, q chunks in groups of SCORE_BLOCK's
    rows: each kv chunk in ascending order goes once through the rows of
    the group's chunks that still read it, a chunk that reads no later kv
    chunk leaving the state after it (causally the chunks that read a kv
    chunk are the group's unfinished tail).  Returns ``[B, Sq, Hkv, G,
    Dh]`` in float32."""
    B, nq, qc, Hkv, G, Dh = qb.shape
    nk, kc = kb.shape[1], kb.shape[2]
    dev = qb.device
    per = max(1, SCORE_BLOCK // (qc * kc))
    k_pos0 = torch.arange(kc, device=dev)
    outs = []
    for g0 in range(0, nq, per):
        g1 = min(nq, g0 + per)
        rows = (g1 - g0) * qc
        # the last kv chunk each q chunk reads: the reference skips a kv
        # chunk that starts past the chunk's last query
        last = [min(nk - 1, (q_offset + j * qc + qc - 1) // kc) if causal
                else nk - 1 for j in range(g0, g1)]
        qg = qb[:, g0:g1].reshape(B, rows, Hkv, G, Dh).permute(0, 2, 3, 1, 4)
        q_pos = q_offset + g0 * qc + torch.arange(rows, device=dev)
        m = torch.full((B, Hkv, G, rows), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, rows), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Hkv, G, rows, Dh), dtype=torch.float32,
                        device=dev)
        done, lo = [], 0          # finished (o, l); first open chunk
        for ki in range(last[-1] + 1):
            r0 = lo * qc
            s = _scores(qg[:, :, :, r0:], kb[:, ki], ki * kc + k_pos0,
                        q_pos[r0:], causal=causal, softcap=softcap, Skv=Skv,
                        scores_dtype=scores_dtype)
            m, l, o = _online_step(s, vb[:, ki], m, l, o)
            n = sum(1 for j in last[lo:] if j == ki)
            if n:                                 # chunks that end here
                done.append((o[..., :n * qc, :], l[..., :n * qc]))
                o, l, m = o[..., n * qc:, :], l[..., n * qc:], m[..., n * qc:]
                lo += n
        if lo < g1 - g0:                          # no kv chunk at all
            done.append((o, l))
        o = torch.cat([d[0] for d in done], dim=3)
        l = torch.cat([d[1] for d in done], dim=3)
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


def _by_pair(qb, kb, vb, *, causal, window, softcap, q_offset, Skv,
             scores_dtype):
    """Windowed attention, a pair of chunks at a time: each q chunk over
    the fixed range of kv chunks from its diagonal chunk down.  Returns
    ``[B, Sq, Hkv, G, Dh]`` in float32."""
    B, nq, qc, Hkv, G, Dh = qb.shape
    nk, kc = kb.shape[1], kb.shape[2]
    dev = qb.device
    q_pos0 = torch.arange(qc, device=dev)
    k_pos0 = torch.arange(kc, device=dev)

    # windowed attention only needs kv chunks within [q - window, q]
    nk_eff = nk
    if causal:
        nk_eff = min(nk, (window + qc) // kc + 2)

    outs = []
    for qi in range(nq):
        qblk = qb[:, qi].permute(0, 2, 3, 1, 4)   # [B, Hkv, G, qc, Dh]
        q_pos = q_offset + qi * qc + q_pos0
        last_q = q_offset + qi * qc + (qc - 1)
        first_q = q_offset + qi * qc
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Hkv, G, qc, Dh), dtype=torch.float32,
                        device=dev)
        for rel in range(nk_eff):
            if nk_eff != nk:
                raw = qi + (q_offset // kc) - rel
                ki = max(raw, 0)
                needed = raw >= 0                 # clamped duplicates skip
            else:
                ki = rel
                needed = True
            if causal:
                needed = needed and ki * kc <= last_q
            needed = needed and ki * kc + kc - 1 >= first_q - window
            if not needed:
                continue
            k_pos = ki * kc + k_pos0
            s = _scores(qblk, kb[:, ki], k_pos, q_pos, causal=causal,
                        softcap=softcap, Skv=Skv, scores_dtype=scores_dtype,
                        window=window)
            m, l, o = _online_step(s, vb[:, ki], m, l, o)
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


def _local_heads(q, k, v, qpl, kpl):
    """The local tensors of q, k and v for attention on each rank's own
    batch rows and query heads, and the function that places a local
    output: q placed by ``qpl``, k and v by ``kpl`` (the same batch
    split; a head split only where q's is the same).  A split of heads
    that do not divide the axis is DTensor's (``ceil(H / ranks)`` a
    rank, the last fewer or none), and the output is placed as q, split
    so.  Where q is whole on the model axis (a projection the rules
    replicate there: ``sharding.split_heads``), each rank takes its chunk
    of the heads there (``sharding.head_chunk``, the same split), q's
    gradient and the output a partial sum there.  Where k and v are
    whole on a mesh dim that splits q's heads (grouped kv heads that the
    ranks do not divide), each rank slices out the kv heads of its query
    heads (a GQA group is contiguous), and their gradient is a partial
    sum over the ranks that share them."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = q.device_mesh
    q = moved(q, qpl, mesh)
    pad = whole_heads_dim(q)
    H = q.shape[2]
    kg = [Partial() if (p.is_shard(2) or d == pad) and not kp.is_shard()
          else kp for d, (p, kp) in enumerate(zip(qpl, kpl))]
    k, v = moved(k, kpl, mesh), moved(v, kpl, mesh)
    G = H // k.shape[2]
    h0, k0 = shard_box(q)[0][2], shard_box(k)[0][2]
    ql = q.to_local(grad_placements=[Partial() if d == pad else p
                                     for d, p in enumerate(qpl)])
    kl, vl = (t.to_local(grad_placements=kg) for t in (k, v))
    if pad is not None:
        c0, n = head_chunk(H, mesh, pad)
        ql = ql[:, :, c0:c0 + n]
        h0 += c0
    hl = ql.shape[2]
    if hl == 0:                         # no heads here: any one kv head
        idx = slice(0, 1)
    elif hl % G == 0 or G % hl == 0:    # whole groups, or one group's part
        idx = slice(h0 // G - k0, h0 // G - k0 + max(hl // G, 1))
    else:                               # a group split across ranks
        idx = torch.arange(h0, h0 + hl, device=kl.device) // G - k0

    def place(o):
        if pad is None:
            return DTensor.from_local(o, mesh, qpl, run_check=False,
                                      shape=q.shape,
                                      stride=contiguous_stride(q.shape))
        return spread(o, {2: (h0, H)}, mesh, qpl, pad)
    return ql, kl[:, :, idx], vl[:, :, idx], place


def _blockwise_attention_on_shards(q, k, v, **kw):
    """:func:`blockwise_attention` over a mesh, each rank on its own batch
    rows and query heads (``sharding.batch_heads``), as GSPMD partitions
    the reference's einsums: the batch split by q's or by k's (a whole
    q, as the cross-attention's, is sliced to k's rows), the heads by
    q's, k and v following (:func:`_local_heads`).  Returns a DTensor
    placed as q's shard."""
    from torch.distributed.tensor import Replicate, Shard

    qpl = [Shard(0) if kp.is_shard(0) else p
           for p, kp in zip(batch_heads(q), k.placements)]
    kpl = [p if p.is_shard(0) or (p.is_shard(2) and kp.is_shard(2))
           else Replicate() for p, kp in zip(qpl, k.placements)]
    ql, kl, vl, place = _local_heads(q, k, v, qpl, kpl)
    return place(blockwise_attention(ql, kl, vl, **kw))


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
    if is_dtensor(k_cache):
        return _decode_attention_on_shards(q, k_cache, v_cache, cache_len,
                                           window=window, softcap=softcap)
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv if Hkv else 0        # a rank without heads
    scale = Dh ** -0.5
    qg = q.reshape(B, Hkv, G, Dh) * scale
    s = matmul(qg.float(), k_cache.float().permute(0, 2, 3, 1))
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None] if cl.dim() == 1 else cl.reshape(1, 1)
    valid = pos[None, :] < cl                      # [B or 1, S]
    if window is not None:
        valid = valid & (pos[None, :] >= cl - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = matmul(p.to(v_cache.dtype).float(),
               v_cache.float().permute(0, 2, 1, 3))
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def _decode_attention_on_shards(q, k_cache, v_cache, cache_len, **kw):
    """:func:`decode_attention` over a mesh, each rank on its local rows
    and query heads (:func:`_local_heads`): q follows the cache's batch
    split and kv-head split, and keeps its own head split where the cache
    is whole (fewer kv heads than ranks).  Only a cache split along its
    sequence moves: it is gathered, where GSPMD partitions the softmax
    (flash-decoding is :func:`seq_sharded_decode_attention`, which the
    reference leaves unwired).  Returns a DTensor placed as q's shard."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = k_cache.device_mesh
    kpl = [Replicate() if p.is_shard(1) else p for p in k_cache.placements]
    q = q if is_dtensor(q) else like(q, k_cache)
    qpl = [Shard(0) if kp.is_shard(0) else Shard(2)
           if kp.is_shard(2) or (p.is_shard(2) and not kp.is_shard())
           else Replicate() for p, kp in zip(q.placements, kpl)]
    ql, kl, vl, place = _local_heads(q, k_cache, v_cache, qpl, kpl)
    cl = torch.as_tensor(cache_len, device=ql.device)
    if cl.dim() == 1:                              # per-row: this rank's
        off, size = shard_box(moved(k_cache, kpl, mesh))
        cl = cl[off[0]:off[0] + size[0]]
    return place(decode_attention(ql, kl, vl, cl, **kw))


def seq_sharded_decode_attention(q, k_cache, v_cache, cache_len, mesh,
                                 seq_axis: str, *,
                                 softcap: Optional[float] = None):
    """Flash-decoding over a KV cache sharded along its sequence over the
    mesh axis ``seq_axis``: each rank scores its local slice, and the
    partial max, sum and output are merged with all-reduces (MAX, SUM,
    SUM) over that axis's process group.  ``q`` and ``cache_len`` are the
    same on every rank; ``k_cache``/``v_cache`` are ``[B, S, Hkv, Dh]``
    DTensors sharded on dim 1 over ``seq_axis`` (or a rank's local slice
    ``[B, S / n, Hkv, Dh]`` as plain tensors).  Returns ``[B, 1, H, Dh]``
    on every rank, as ``decode_attention``."""
    from repro_torch.models.sharding import is_dtensor

    group = mesh.get_group(seq_axis)
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    idx = mesh.get_local_rank(seq_axis)
    if is_dtensor(k_cache):
        k_cache, v_cache = k_cache.to_local(), v_cache.to_local()
    B, _, H, Dh = q.shape
    shard, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    qg = q.reshape(B, Hkv, G, Dh) * scale
    s = matmul(qg.float(), k_cache.float().permute(0, 2, 3, 1))
    s = _softcap(s, softcap)
    pos = idx * shard + torch.arange(shard, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None] if cl.dim() == 1 else cl.reshape(1, 1)
    valid = pos[None, :] < cl
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    if n > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(dim=-1)
    o = matmul(p.to(v_cache.dtype).float(),
               v_cache.float().permute(0, 2, 1, 3))
    if n > 1:
        dist.all_reduce(lsum, group=group)
        dist.all_reduce(o, group=group)
    o = o / torch.clamp(lsum[..., None], min=1e-30)
    return o.reshape(B, 1, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def kv_split_by_heads(cfg) -> bool:
    """Whether an attention's wk and wv are split by whole heads where
    wq is (``Attention.head_leaves``): every query head has its own kv
    head.  Grouped kv heads are shared by query heads on several ranks,
    and stay split as the rules split them."""
    return cfg.num_kv_heads == cfg.num_heads


class Attention(nn.Module):
    """GQA projections (``attn_init``): wq ``[d, H·Dh]``, wk and wv ``[d,
    Hkv·Dh]``, wo ``[H·Dh, d]``, and with ``qk_norm`` q_ln / k_ln over Dh.
    Over a model axis that the heads do not divide, wq's columns and wo's
    rows are split by whole heads (:meth:`head_leaves`), and so are wk's
    and wv's where each query head has its own kv head."""

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
        for name in ("wq", "wk", "wv", "wo"):
            init_(self, name, lambda t: dense_init_(t, gen))
        if self.cfg.qk_norm:
            self.q_ln.init(gen)
            self.k_ln.init(gen)

    def head_leaves(self) -> dict:
        """``{weight: (its flat heads dim, heads)}`` for
        ``sharding.leaf_heads``: wq and wo, and wk and wv where
        :func:`kv_split_by_heads`."""
        h = self.cfg.num_heads
        out = {"wq": (1, h), "wo": (0, h)}
        if kv_split_by_heads(self.cfg):
            out.update(wk=(1, h), wv=(1, h))
        return out

    def qkv(self, x: torch.Tensor, positions: torch.Tensor,
            attn_shard: str = "heads"):
        """Project + rope.  x: [B, S, D] -> q [B,S,H,Dh], k/v [B,S,Hkv,Dh].
        Over a mesh, ``attn_shard="flat"`` constrains the projections'
        flattened H·Dh outputs over the model axis, ``"heads"`` q's heads
        (the reference's ``attn_qkv``)."""
        cfg = self.cfg
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()

        def proj(w, n):
            if heads_of(w) is not None:   # split by whole heads already
                return heads_in(x, w, n, dh)
            f = linear(x, w.to(x.dtype))
            if attn_shard == "flat":
                f = cns(f, ("pod", "data"), None, "model")
            return split_heads(f, n, dh)
        q, k, v = proj(self.wq, h), proj(self.wk, hkv), proj(self.wv, hkv)
        if attn_shard == "heads":
            q = cns(q, ("pod", "data"), None, "model", None)
        if cfg.qk_norm:
            q = self.q_ln(q, cfg.norm, cfg.norm_eps)
            k = self.k_ln(k, cfg.norm, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def out(self, o: torch.Tensor, attn_shard: str = "heads") -> torch.Tensor:
        if heads_of(self.wo) is not None:   # o split on wo's heads
            y = heads_out(o, self.wo)
        else:
            of = merge_heads(o)
            if attn_shard == "flat":
                of = cns(of, ("pod", "data"), None, "model")  # row-parallel
            y = linear(of, self.wo.to(o.dtype))
        return cns(y, ("pod", "data"), None, None)


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
        for name in ("wi", "wo", "wg"):
            if getattr(self, name) is not None:
                init_(self, name, lambda t: dense_init_(t, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = x.dtype
        hi = linear(x, self.wi.to(cdt))
        hi = cns(hi, ("pod", "data"), None, "model")
        if self.wg is not None:
            hi = _act(linear(x, self.wg.to(cdt)), self.act) * hi
        else:
            hi = _act(hi, self.act)
        y = linear(hi, self.wo.to(cdt))
        return cns(y, ("pod", "data"), None, None)
