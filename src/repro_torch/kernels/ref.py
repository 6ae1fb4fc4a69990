"""Plain PyTorch versions of the CUDA kernels.

They run on any device: ``ops`` sends CPU tensors here, the tests hold
them against the JAX package, and ``chip_smoke.py`` holds each kernel
against them on the card.  They use no library reduction
(``scatter_reduce``, ``index_add_``, ``segment_reduce``): the segment
reduction is a segmented inclusive scan over dst-sorted edges (log-step
doubling), read off at each row's last edge — the same "each row owns a
contiguous edge range" structure the kernels use, in another order of
summation.  Compaction is positions from a ``cumsum`` plus an indexed
store (no ``nonzero``, no ``masked_select``).
"""
from __future__ import annotations

import torch

_COMBINE_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def identity(combine: str, dtype: torch.dtype):
    """Identity of the combine monoid for ``dtype``: 0, the largest value
    (+inf for floats) or the smallest (-inf)."""
    if combine == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if combine == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if combine == "min" else info.min


def segment_reduce(contrib: torch.Tensor, dst: torch.Tensor,
                   num_segments: int, combine: str,
                   sorted_ids: bool = True, blocks=None) -> torch.Tensor:
    """Reduce contrib ``[E(, Q)]`` by dst ``[E]`` into ``[R(, Q)]`` rows
    (R = num_segments) with the ``combine`` monoid; empty rows hold its
    identity and ids outside ``[0, R)`` are dropped.  ``blocks`` (the
    kernel's block sizes) is accepted and changes nothing.

    ``dst`` must be ascending unless ``sorted_ids=False``, which first
    permutes the edges by a stable sort on dst.  Integer contributions
    accumulate in int64 and are cast back (wrapping like a same-width
    accumulator would)."""
    op = _COMBINE_OPS.get(combine)
    if op is None:
        raise ValueError(f"unknown combine: {combine}")
    squeeze = contrib.ndim == 1
    c = contrib[:, None] if squeeze else contrib
    if not sorted_ids:
        dst, perm = torch.sort(dst, stable=True)
        c = c.index_select(0, perm)
    ident = identity(combine, contrib.dtype)
    out_shape = (num_segments, c.shape[1])
    if c.shape[0] == 0 or num_segments == 0:
        out = torch.full(out_shape, ident, dtype=contrib.dtype,
                         device=contrib.device)
        return out[:, 0] if squeeze else out

    x = c if contrib.dtype.is_floating_point else c.to(torch.int64)
    d = dst.to(torch.int64)
    rows = torch.arange(num_segments, device=d.device)
    lo = torch.searchsorted(d, rows)
    hi = torch.searchsorted(d, rows, right=True)
    count = hi - lo
    longest = int(count.max())
    shift = 1
    while shift < longest:
        # x[i] <- x[i - shift] (op) x[i] where both edges share a row
        same = (d[shift:] == d[:-shift])[:, None]
        y = x.clone()
        y[shift:] = torch.where(same, op(x[:-shift], x[shift:]), x[shift:])
        x = y
        shift *= 2
    last = x.index_select(0, (hi - 1).clamp(min=0))
    out = torch.where((count > 0)[:, None], last,
                      torch.full_like(last, ident)).to(contrib.dtype)
    return out[:, 0] if squeeze else out


def gab_fused_ref(spec, src_vals, a, b, dst_local, old, base, num_rows,
                  row_cap, blocks=None):
    """One Gather+Apply tile step with ``gab_fused``'s contract.

    Shapes: src_vals ``[E(, Q)]``, a/b/dst_local ``[E]``, old/base
    ``[R(, Q)]`` with R = row_cap; dst_local ascending.  The message is
    ``src · a + b + add_const``, the apply ``alpha · base + beta · acc``
    (base 1.0 when absent) or ``min``/``max`` against ``old``, each
    product and sum rounded on its own.  Rows at or past ``num_rows``
    keep ``old`` and are not updated.  Returns ``(new [R(, Q)], updated
    [R(, Q)] bool)``.  ``blocks`` (the kernel's block sizes) is accepted
    and changes nothing."""
    squeeze = src_vals.ndim == 1
    contrib = src_vals[:, None] if squeeze else src_vals
    ov = old[:, None] if squeeze else old
    if spec.scale_aux:
        contrib = contrib * a[:, None]
    if spec.add_edge:
        contrib = contrib + b[:, None]
    if spec.add_const is not None:
        contrib = contrib + spec.add_const
    acc = segment_reduce(contrib, dst_local, row_cap, spec.combine)
    if spec.apply == "affine":
        if spec.base_aux:
            bv = base[:, None] if squeeze else base
            new = spec.alpha * bv + spec.beta * acc
        else:
            new = spec.alpha + spec.beta * acc
    elif spec.apply == "min":
        new = torch.minimum(ov, acc)
    elif spec.apply == "max":
        new = torch.maximum(ov, acc)
    else:
        raise ValueError(f"unknown apply: {spec.apply}")
    valid = (torch.arange(row_cap, device=ov.device) < int(num_rows))[:, None]
    new = torch.where(valid, new, ov)
    if spec.update_tol > 0.0:
        upd = (new - ov).abs() > spec.update_tol
    else:
        upd = new != ov
    upd = valid & upd
    if squeeze:
        return new[:, 0], upd[:, 0]
    return new, upd


def compact(mask: torch.Tensor, values: torch.Tensor, capacity: int,
            fill_index: int | None = None):
    """First ``capacity`` set indices of mask ``[V]`` (ascending) and their
    values ``[V]``, as ``([K] int32, [K])`` with K = capacity; when more
    than K entries are set, the first K.  Unused slots hold
    ``(fill_index, 0)``; ``fill_index`` defaults to V.  A mask of another
    dtype than bool reads as ``mask != 0``."""
    n = mask.shape[0]
    fill = n if fill_index is None else int(fill_index)
    m = mask if mask.dtype == torch.bool else mask != 0
    pos = torch.cumsum(m.to(torch.int64), 0) - 1
    # kept entries store at their position; the rest at the dump slot K
    slot = torch.where(m & (pos < capacity), pos,
                       torch.full_like(pos, capacity))
    idx = torch.full((capacity + 1,), fill, dtype=torch.int32,
                     device=mask.device)
    val = torch.zeros(capacity + 1, dtype=values.dtype, device=values.device)
    idx[slot] = torch.arange(n, dtype=torch.int32, device=mask.device)
    val[slot] = values
    return idx[:capacity], val[:capacity]
