"""Device dispatch for the kernels.

A CUDA tensor launches the hand-written kernel (``gab_gather``,
``gab_fused``, ``compact``); a CPU tensor runs the plain PyTorch version
(``ref``);
any other device raises.  The two GAB kernels take ``blocks``, checked
here on either device (``blocks.check_blocks``).  Nothing here falls back from the kernel: a
kernel that cannot build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import blocks as _blocks
from repro_torch.kernels import compact as _cp
from repro_torch.kernels import gab_fused as _gf
from repro_torch.kernels import gab_gather as _gg
from repro_torch.kernels import ref as _ref


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def segment_reduce(contrib: torch.Tensor, dst: torch.Tensor,
                   num_segments: int, combine: str,
                   sorted_ids: bool = True, blocks=None) -> torch.Tensor:
    """``combine``-reduce contrib ``[E(, Q)]`` by dst ``[E]`` into
    ``[R(, Q)]`` rows (R = num_segments) at the kernel's ``blocks``
    ``(block_e, block_r)`` (None: the default); see ``gab_gather``."""
    _blocks.check_blocks(blocks)
    fn = _gg.segment_reduce if _on_card(contrib) else _ref.segment_reduce
    return fn(contrib, dst, num_segments, combine, sorted_ids, blocks=blocks)


def segment_sum(contrib, dst, num_segments, sorted_ids=True):
    """Sum-reduce contrib ``[E(, Q)]`` by dst ``[E]`` into ``[R(, Q)]``."""
    return segment_reduce(contrib, dst, num_segments, "sum", sorted_ids)


def segment_min(contrib, dst, num_segments, sorted_ids=True):
    """Min-reduce contrib ``[E(, Q)]`` by dst ``[E]`` into ``[R(, Q)]``
    (+inf for empty segments)."""
    return segment_reduce(contrib, dst, num_segments, "min", sorted_ids)


def segment_max(contrib, dst, num_segments, sorted_ids=True):
    """Max-reduce contrib ``[E(, Q)]`` by dst ``[E]`` into ``[R(, Q)]``
    (-inf for empty segments)."""
    return segment_reduce(contrib, dst, num_segments, "max", sorted_ids)


def gab_fused(spec, src_vals, a, b, dst_local, old, base, num_rows, row_cap,
              blocks=None):
    """One fused Gather+Apply tile step over src_vals ``[E(, Q)]`` and old
    ``[R(, Q)]`` at the kernel's ``blocks`` ``(block_e, block_r)`` (None:
    the default); returns ``(new, updated)`` — see ``gab_fused``."""
    _blocks.check_blocks(blocks)
    fn = _gf.gab_fused if _on_card(src_vals) else _ref.gab_fused_ref
    return fn(spec, src_vals, a, b, dst_local, old, base, num_rows, row_cap,
              blocks=blocks)


def compact(mask, values, capacity, fill_index=None):
    """First ``capacity`` set indices of mask ``[V]`` (ascending) and their
    values ``[V]``, as ``([K] int32, [K])``; unused slots hold
    ``(fill_index, 0)`` (default V).  A mask of another dtype than bool
    is read as ``mask != 0``.  The CUDA kernel has no bound on V below
    2^31, so nothing here falls back to the plain version."""
    if mask.dtype != torch.bool:
        mask = mask != 0
    fn = _cp.compact if _on_card(mask) else _ref.compact
    return fn(mask, values, capacity, fill_index)
