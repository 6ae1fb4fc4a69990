"""GAB (Gather-Apply-Broadcast) computation model (paper §III-C) on PyTorch.

A vertex-centric program supplies:
  * ``init``     — initial vertex value array + auxiliary per-vertex arrays
                   (numpy, host side)
  * ``gather``   — per-edge contribution f(src_value, edge_value, aux_src)
  * ``combine``  — the reduction monoid over contributions ("sum"/"min"/"max")
  * ``apply``    — new_value g(old_value, accumulator, aux_dst)

The engine runs supersteps: every server holds a replica of *all* vertex
values (All-in-All policy), processes its assigned tiles one at a time
(Gather+Apply are purely local), and Broadcasts only *updated* values.

This module holds the single-tile step the tiled engine runs
(``run_tile`` → ``tile_gather_apply``).  ``seg_impl`` picks the kernel:
``"fused"`` runs gather→combine→apply→mask as one kernel for programs with
a :class:`~repro_torch.kernels.gab_fused.FusedSpec` and the segment kernel
otherwise; ``"segment"`` always runs the program's own gather and apply
around the segment kernel.  On a CPU device both run the plain versions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor

SEG_IMPLS = ("fused", "segment")


def state_from_numpy(state: dict[str, np.ndarray],
                     device) -> dict[str, Tensor]:
    """Tensors on ``device`` for a dict of host arrays — a program's
    ``init()`` dict, or a reference run's ``values`` and ``aux`` — so the
    port starts from exactly the same state."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in state.items()}


def segment_reduce(data: Tensor, segment_ids: Tensor, num_segments: int,
                   combine: str, sorted_ids: bool = True) -> Tensor:
    """Reduce ``data`` ``[E(, Q)]`` into ``num_segments`` rows with the
    given monoid (segments along axis 0).  Tile edges are CSR-sorted by
    dst, so ``sorted_ids=True`` by default."""
    return ops.segment_reduce(data, segment_ids, num_segments, combine,
                              sorted_ids)


@dataclasses.dataclass(eq=False)
class VertexProgram:
    """Base class for GAB vertex programs.  Subclasses override the four
    hooks below; ``gather``/``apply`` take and return tensors."""

    combine: str = "sum"
    #: names of auxiliary per-vertex arrays gathered at the *source* side
    src_aux: tuple[str, ...] = ()
    #: names of auxiliary per-vertex arrays consumed by apply at the dst side
    dst_aux: tuple[str, ...] = ()
    #: tolerance used to decide whether a value "changed" (paper: broadcast
    #: only updated values); exact (0.0) for discrete programs.
    update_tol: float = 0.0

    #: query instances per edge pass; the port runs single-query (1) only
    num_queries = 1

    # -- hooks ------------------------------------------------------------
    def init(self, num_vertices: int, out_degree: np.ndarray,
             in_degree: np.ndarray, **kw) -> dict[str, np.ndarray]:
        """Return {"value": ..., <aux name>: ...} — value ``[V]``, aux
        arrays ``[V]``, given out/in degrees ``[V]``."""
        raise NotImplementedError

    def gather(self, src_value: Tensor, edge_val: Tensor,
               aux: dict[str, Tensor]) -> Tensor:
        """Per-edge message: f(src values [E], edge values [E], src aux)."""
        raise NotImplementedError

    def apply(self, old_value: Tensor, accum: Tensor,
              aux: dict[str, Tensor]) -> Tensor:
        """New dst values g(old [R], accumulated messages, dst aux)."""
        raise NotImplementedError

    # -- derived ----------------------------------------------------------
    def updated_mask(self, old: Tensor, new: Tensor) -> Tensor:
        """Elementwise "value changed" mask over old/new ``[V]`` — exact
        (!=) or |new - old| > update_tol for tolerance-based programs."""
        if self.update_tol > 0.0:
            return (new - old).abs() > self.update_tol
        return new != old

    def fused_spec(self):
        """:class:`~repro_torch.kernels.gab_fused.FusedSpec` of this
        program's gather/apply, or ``None`` when it has no affine form —
        the ``"fused"`` path then runs the segment kernel for it."""
        return None


def _fused_tile(fs, src_vals, src_aux, edge_val, dst_local, old, dst_aux,
                num_rows, row_cap):
    """Run one tile through the fused kernel.  The per-edge affine terms
    are formed here with the programs' own association —
    ``a = src_aux[scale_aux] * edge_val`` (edge_val is exactly 1.0 on real
    unweighted edges)."""
    a = src_aux[fs.scale_aux] * edge_val if fs.scale_aux else None
    b = edge_val if fs.add_edge else None
    base = dst_aux[fs.base_aux] if fs.base_aux else None
    return ops.gab_fused(fs, src_vals, a, b, dst_local, old, base, num_rows,
                         row_cap)


def tile_gather_apply(
    prog: VertexProgram,
    values: Tensor,               # [V] replicated vertex values
    aux: dict[str, Tensor],       # per-vertex aux arrays, each [V]
    src: Tensor,                  # [E] global source ids (padding -> 0)
    dst_local: Tensor,            # [E] dst - row_start; padding >= num_rows
    edge_val: Tensor,             # [E]
    row_start: int,
    num_rows: int,                # <= row_cap
    row_cap: int,
    seg_impl: str = "fused",
) -> tuple[Tensor, Tensor, Tensor]:
    """Gather+Apply for one tile, on the device of ``values``.

    Returns (rows [row_cap] global ids clipped to V-1, new_values
    [row_cap], updated [row_cap] bool).  Rows beyond num_rows are masked
    not-updated."""
    if seg_impl not in SEG_IMPLS:
        raise ValueError(f"seg_impl {seg_impl!r}: the port has "
                         f"{', '.join(SEG_IMPLS)}")
    nv = values.shape[0]
    src_vals = values.index_select(0, src)
    src_aux = {k: aux[k].index_select(0, src) for k in prog.src_aux}
    local_rows = torch.arange(row_cap, device=values.device)
    rows = (row_start + local_rows).clamp(max=nv - 1)
    old = values.index_select(0, rows)
    dst_aux = {k: aux[k].index_select(0, rows) for k in prog.dst_aux}

    fs = prog.fused_spec() if seg_impl == "fused" else None
    if fs is not None:
        new, updated = _fused_tile(fs, src_vals, src_aux, edge_val,
                                   dst_local, old, dst_aux, num_rows, row_cap)
        return rows, new, updated

    contrib = prog.gather(src_vals, edge_val, src_aux)
    accum = segment_reduce(contrib, dst_local, row_cap + 1,
                           prog.combine)[:row_cap]
    new = prog.apply(old, accum, dst_aux)
    valid = local_rows < num_rows
    new = torch.where(valid, new, old)
    updated = valid & prog.updated_mask(old, new)
    return rows, new, updated


def run_tile(prog, values, aux, tile_arrays, row_start, num_rows, row_cap,
             seg_impl="fused"):
    """Out-of-core engine entry point for one tile: ``tile_arrays`` are the
    host ``(src, dst_local, edge_val)`` arrays ``[E]``, copied to the
    device of ``values`` once each.  Returns device tensors ``(rows, new,
    updated)``; the caller moves them to the host."""
    src, dst_local, edge_val = (torch.from_numpy(x).to(values.device)
                                for x in tile_arrays)
    return tile_gather_apply(prog, values, aux, src, dst_local, edge_val,
                             int(row_start), int(num_rows), row_cap,
                             seg_impl)
