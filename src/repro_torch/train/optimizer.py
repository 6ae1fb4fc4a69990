"""AdamW, its learning-rate schedule and the gradient transforms — the
port's counterpart of ``repro/train/optimizer.py``, written by hand on
float32 tensors in the reference's order of operations (not
``torch.optim.AdamW``, which orders the decay and the bias corrections
differently).

A tree here is the reference's pytree: nested dicts, walked in sorted key
order as ``jax.tree.leaves`` walks them.  A leaf is a tensor, or a list of
tensors: the members of one of the reference's stacked leaves (a
``cycles`` leaf ``[n_cycles, ...]`` is one tensor a cycle in the port,
``model_zoo.param_tree``).  Whatever the reference computes over a whole
leaf, the port computes over all its members: the global norm, top-k's
threshold and its density.  The weight-decay rule looks at a member, so
it sees the leaf without its stack axis (ROADMAP.md C: the reference
decays the norm scales of its stacked cycles, and only those).

``adamw_update`` updates params, m and v in place (the reference donates
their buffers) and returns them.

Over a device mesh every tensor here is a DTensor: a parameter and its
gradient in the parameter's placements, m, v and the residual in their
ZeRO-1 placements (``train_step.state_specs``).  Each member's sum of
squares, top-k's threshold and its kept count are reduced across ranks to
one value on every rank; the update runs on m's shard and is gathered
back to the parameter's placements.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.sharding import full, keep_heads, placed_as


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def leaves(tree) -> list:
    """The tree's leaves in the reference's order (dict keys sorted); a
    list is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def members(leaf) -> list:
    """The tensors of one leaf: a stacked leaf's members, or the leaf."""
    return list(leaf) if isinstance(leaf, list) else [leaf]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over the tree's leaves, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def member_map(fn, tree, *rest):
    """``fn`` over every member tensor; a stacked leaf stays a list."""
    def one(leaf, *others):
        if isinstance(leaf, list):
            return [fn(*xs) for xs in zip(leaf, *others)]
        return fn(leaf, *others)
    return tree_map(one, tree, *rest)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# schedule and clipping
# ---------------------------------------------------------------------------

def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``
    of it at ``decay_steps``; float32 throughout, as the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in tree order, of each leaf's sum of
    squares in float32."""
    return torch.sqrt(sum(
        sum(full(torch.sum(torch.square(x.float()))) for x in members(leaf))
        for leaf in leaves(tree)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return member_map(lambda g: g * scale.to(g.dtype), grads), gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    """Zero float32 moments, one tensor for each member, and step 0."""
    first = members(leaves(params)[0])[0]
    return {"m": member_map(_zeros_f32, params),
            "v": member_map(_zeros_f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step on every member: the step counter, the schedule, the
    global-norm clip (the norm reported before clipping), the moments,
    the bias corrections, the decoupled decay of members with ndim >= 2.
    Returns ``(params, {"m", "v", "step"}, {"lr", "grad_norm"})``; params,
    m and v are updated in place."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, g, m, v):
        g = placed_as((g * scale.to(g.dtype)).float(), m)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * placed_as(p, m).float()
        p.copy_((p.float() - lr * placed_as(delta, p)).to(p.dtype))

    for lp, lg, lm, lv in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
        for p, g, m, v in zip(members(lp), members(lg), members(lm),
                              members(lv)):
            upd(p, g, m, v)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# GraphH-style gradient compression: top-k sparsification + error feedback
# (the paper's hybrid dense/sparse broadcast applied to DP gradient exchange)
# ---------------------------------------------------------------------------

def ef_init(params) -> dict:
    return {"residual": member_map(_zeros_f32, params)}


def topk_compress(grads, ef_state, density: float = 0.01):
    """Keep the top ``density`` fraction of each leaf (by |g + residual|,
    over all the members of a stacked leaf), accumulate the rest into the
    error-feedback residual.  Entries tied at the threshold all pass.

    Returns (sparse grads, new ef state, stats with the measured wire
    ratio): on a cluster the sparse tensors are what crosses the network
    (as (idx, val) pairs — GraphH's sparse mode), so wire bytes scale with
    density * (1 + idx overhead) instead of 1.0.
    """
    def one(g_leaf, r_leaf):
        gs, rs = members(g_leaf), members(r_leaf)
        # laid out as the residual (by whole heads where it is so split)
        accs = [keep_heads(placed_as(g.float(), r) + r, r)
                for g, r in zip(gs, rs)]
        # the leaf's global top k, as GSPMD computes it: over a mesh each
        # member is gathered whole for the threshold
        flat = torch.cat([full(a).abs().reshape(-1) for a in accs])
        size = flat.shape[0]
        k = max(1, int(density * size))
        thresh = torch.topk(flat, k).values[-1]
        del flat
        sent, resid, kept = [], [], 0
        for a, g in zip(accs, gs):
            mask = torch.abs(a) >= thresh
            s = torch.where(mask, a, 0.0)
            sent.append(s.to(g.dtype))
            resid.append(keep_heads(a - s, a))
            kept = kept + full(mask.sum())
        dens = kept.to(torch.float32) / size
        if not isinstance(g_leaf, list):
            return sent[0], resid[0], dens
        return sent, resid, dens

    outs = tree_map(one, grads, ef_state["residual"])
    new_g = tree_map(lambda o: o[0], outs)
    new_r = tree_map(lambda o: o[1], outs)
    mean_density = torch.mean(torch.stack([o[2] for o in leaves(outs)]))
    # wire model: dense = 4B/elem; sparse = density * (4B idx + 4B val)
    wire_ratio = mean_density * 2.0
    return new_g, {"residual": new_r}, {"density": mean_density,
                                        "wire_ratio": wire_ratio}

