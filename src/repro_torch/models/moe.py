"""Mixture-of-Experts FFN with sort-based dispatch — counterpart of
``repro/models/moe.py`` on one device.

Dispatch as in the reference (no ``[T, E, C]`` one-hot):

  1. router top-k per token -> (expert_id, gate) pairs, flattened [T*k]
  2. stable-sort assignments by expert; position-within-expert via
     ``searchsorted``; drop assignments past the per-expert capacity
     C = k*T/E * cf (rounded up to 8, at least 8)
  3. token ids into an ``[E, C]`` grid, tokens gathered to ``[E, C, D]``,
     the expert FFNs as batched matmuls, the gated outputs combined back
     to ``[T, D]``.

The reference combines with a scatter-add.  Here each token gathers its k
expert outputs ``[T, k, D]`` and sums them in ascending expert order (the
reference's scatter order), and both gathers are ``F.embedding``, whose
backward sums repeated rows in a fixed order on the card: no float
atomics, so two equal train steps give equal bits.

Over a device mesh the token grid and the expert FFN shard the experts
over the model axis and the capacity over the data axes (``cns``, as the
reference), each rank running its own experts on its own slots
(``sharding.linear``).  The router's product runs on each rank's own
tokens, split over every mesh axis, and only its ``[T, E]`` logits are
gathered.  The routing — top-k, the stable sort, ``searchsorted`` and
the two ``F.embedding`` gathers — has no DTensor sharding rule, so it runs
on those whole logits and the whole ``[T, D]`` tokens on every rank
(``sharding.full``; gradients flow back to the shards), the same
routing as without a mesh.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.sharding import (cns, full, is_dtensor, like,
                                         linear, linear_f32, moved)


_ROUTER_LOG: ContextVar = ContextVar("router_log", default=None)


@contextlib.contextmanager
def recording_router_logits():
    """Yields a list that collects every :func:`moe_apply` call's float32
    router logits ``[T, E]`` (detached, on the host) in call order while
    the context is open: the routing a bfloat16 run chose, to be held
    against another run's (``numerics.router_flips``)."""
    log = []
    token = _ROUTER_LOG.set(log)
    try:
        yield log
    finally:
        _ROUTER_LOG.reset(token)


def moe_capacity(num_tokens: int, cfg) -> int:
    c = int(cfg.experts_per_token * num_tokens * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


class MoE(nn.Module):
    """``moe_init``: router ``[d, E]``, wi and wg ``[E, d, f]``, wo ``[E,
    f, d]``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.cfg = cfg
        self.router = L.new_param(d, e, device=device)
        self.wi = L.new_param(e, d, f, device=device)
        self.wg = L.new_param(e, d, f, device=device)
        self.wo = L.new_param(e, f, d, device=device)

    def init(self, gen: torch.Generator) -> None:
        for name in ("router", "wi", "wg", "wo"):
            L.init_(self, name, lambda t: L.dense_init_(t, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_apply(self, x, self.cfg)


def _each_rank_rows(x):
    """A DTensor ``x [T, D]`` split along T over every mesh dim where it
    is whole too (a local slice), when T divides evenly: each rank then
    holds rows no other rank holds.  ``x`` itself otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    mesh, n = x.device_mesh, 1
    for d in range(mesh.ndim):
        n *= mesh.size(d)
    if x.shape[0] % n or any(p.is_shard() and p.dim != 0
                             for p in x.placements):
        return x
    return moved(x, [Shard(0)] * mesh.ndim)


def moe_dispatch(eids: torch.Tensor, cfg, capacity: int):
    """Sort-based dispatch of the top-k expert ids ``[T, K]``: returns
    ``(slot [T, K], grid_tok [E, C])``.  ``slot`` is each assignment's
    place ``e·C + pos`` in the flat grid, ``E·C`` where capacity dropped
    it; ``grid_tok`` holds the token of each slot, ``T`` where none."""
    T, K = eids.shape
    E, C = cfg.num_experts, capacity
    dev = eids.device
    flat_e = eids.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev),
                                   side="left")
    pos = torch.arange(T * K, device=dev) - seg_start[se]
    lin = torch.where(pos < C, se * C + pos, torch.full_like(se, E * C))
    # one slot past the grid takes the dropped assignments, then goes
    grid_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    grid_tok[lin] = st
    slot = torch.empty_like(lin)
    slot[order] = lin
    return slot.reshape(T, K), grid_tok[:E * C].reshape(E, C)


def moe_apply(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    B, S, D = x.shape
    T = B * S
    E = cfg.num_experts
    C = moe_capacity(T, cfg)
    cdt = x.dtype
    xt = x.reshape(T, D)

    # the router's product on each rank's tokens, its [T, E] logits
    # gathered: routing has no DTensor sharding rule, so it runs on whole
    # tensors on every rank
    logits = full(linear_f32(_each_rank_rows(xt), p.router.to(cdt)))
    log = _ROUTER_LOG.get()
    if log is not None:
        log.append(logits.detach().cpu())
    # the k largest, ties to the lower expert id as lax.top_k breaks them:
    # torch.topk leaves the order of ties open (the CPU's prefers the
    # higher id), and bfloat16 router logits tie often
    gates, eids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = gates[:, :cfg.experts_per_token]
    eids = eids[:, :cfg.experts_per_token]
    gates = torch.softmax(gates, dim=-1)
    slot, grid_tok = moe_dispatch(eids, cfg, C)

    # gather tokens -> [E, C, D]; empty slots read row T, a zero row
    xr = full(xt)
    xpad = torch.cat([xr, xr.new_zeros(1, D)])
    xe = like(F.embedding(grid_tok, xpad), x)
    xe = cns(xe, "model", ("pod", "data"), None)  # EP x DP: tokens over dp

    # expert FFN, batched over E
    hi = linear(xe, p.wi.to(cdt))
    hg = linear(xe, p.wg.to(cdt))
    h = L._act(hg, cfg.act) * hi
    h = cns(h, "model", ("pod", "data"), None)
    ye = full(linear(h, p.wo.to(cdt))).reshape(E * C, D)

    # combine: each token's k outputs in ascending expert order; a dropped
    # assignment reads row E*C, a zero row
    by_e = torch.argsort(eids, dim=-1)
    slot = torch.gather(slot, 1, by_e)
    g = torch.gather(gates, 1, by_e).to(cdt)
    yk = F.embedding(slot, torch.cat([ye, ye.new_zeros(1, D)]))  # [T, K, D]
    yk = yk * g[..., None]
    out = yk[:, 0]
    for k in range(1, yk.shape[1]):
        out = out + yk[:, k]
    return cns(like(out, x).reshape(B, S, D), ("pod", "data"), None, None)
