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

This module holds the step functions the engine modes run: one tile
(``run_tile`` → ``tile_gather_apply``, tiled mode; ``run_tile_sharded``
→ ``tile_gather_apply_sharded`` on inputs the caller gathered, the
out-of-core vertex state), a stack of tiles
(``run_tile_stack`` → ``stacked_tiles_step``, pipelined and stacked modes)
and one server's merged edge list (``merged_server_step``, merged mode).
``seg_impl`` picks the kernel: ``"fused"`` runs gather→combine→apply→mask
as one kernel for programs with a
:class:`~repro_torch.kernels.gab_fused.FusedSpec` and the segment kernel
otherwise; ``"segment"`` always runs the program's own gather and apply
around the segment kernel.  The merged step masks rows by ownership, which
the fused kernel's row test cannot express, so it runs the segment kernel
under either name, as the reference does.  ``blocks`` is the kernels'
``(block_e, block_r)`` (the engine's ``kernel_plan``: the tuner's pick
or ``EngineConfig.kernel_blocks``; None for the static default), passed
to whichever kernel a step runs; it changes no bit.  On a CPU device
every step runs the kernels' plain versions.

Multi-query axis: vertex values may be ``[V]`` (one program instance) or
``[V, Q]`` (Q instances in the same tile visit — personalized PageRank
seeds, multi-source BFS, landmark distances).  Every step here is
shape-polymorphic over that trailing query axis; aux arrays may be ``[V]``
(shared across queries) or ``[V, Q]`` (per query, e.g. PPR seed mass).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor

SEG_IMPLS = ("fused", "segment")

COMBINE_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def state_from_numpy(state: dict[str, np.ndarray],
                     device) -> dict[str, Tensor]:
    """Tensors on ``device`` for a dict of host arrays — a program's
    ``init()`` dict, or a reference run's ``values`` and ``aux`` — so the
    port starts from exactly the same state."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in state.items()}


def segment_reduce(data: Tensor, segment_ids: Tensor, num_segments: int,
                   combine: str, sorted_ids: bool = True,
                   blocks=None) -> Tensor:
    """Reduce ``data`` ``[E(, Q)]`` into ``num_segments`` rows with the
    given monoid (segments along axis 0) at the kernel's ``blocks``.
    Tile edges are CSR-sorted by dst, so ``sorted_ids=True`` by
    default."""
    return ops.segment_reduce(data, segment_ids, num_segments, combine,
                              sorted_ids, blocks=blocks)


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

    #: query instances per edge pass; values are [V, num_queries] when > 1
    #: (batched programs derive it from their seeds)
    num_queries = 1

    # -- hooks ------------------------------------------------------------
    def init(self, num_vertices: int, out_degree: np.ndarray,
             in_degree: np.ndarray, **kw) -> dict[str, np.ndarray]:
        """Return {"value": ..., <aux name>: ...} — value ``[V(, Q)]``, aux
        arrays ``[V(, Q)]``, given out/in degrees ``[V]``."""
        raise NotImplementedError

    def gather(self, src_value: Tensor, edge_val: Tensor,
               aux: dict[str, Tensor]) -> Tensor:
        """Per-edge message: f(src values [E(, Q)], edge values [E], src
        aux)."""
        raise NotImplementedError

    def apply(self, old_value: Tensor, accum: Tensor,
              aux: dict[str, Tensor]) -> Tensor:
        """New dst values g(old [R(, Q)], accumulated messages, dst aux)."""
        raise NotImplementedError

    # -- derived ----------------------------------------------------------
    @property
    def identity(self) -> float:
        """Identity element of the combine monoid (0 / +inf / -inf)."""
        return COMBINE_IDENTITY[self.combine]

    def updated_mask(self, old: Tensor, new: Tensor) -> Tensor:
        """Elementwise "value changed" mask over old/new ``[V(, Q)]`` — exact
        (!=) or |new - old| > update_tol for tolerance-based programs."""
        if self.update_tol > 0.0:
            return (new - old).abs() > self.update_tol
        return new != old

    def fused_spec(self):
        """:class:`~repro_torch.kernels.gab_fused.FusedSpec` of this
        program's gather/apply, or ``None`` when it has no affine form —
        the ``"fused"`` path then runs the segment kernel for it."""
        return None


def _bcast_rows(mask: Tensor, ref: Tensor) -> Tensor:
    """Broadcast a per-row [R] mask against [R] or [R, Q] data."""
    return mask[:, None] if ref.ndim == 2 else mask


def _row_pad(arr: Tensor, pad: int) -> Tensor:
    """Append ``pad`` zero rows (any trailing shape) to ``arr``."""
    return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])


def _fused_tile(fs, src_vals, src_aux, edge_val, dst_local, old, dst_aux,
                num_rows, row_cap, blocks=None):
    """Run one tile through the fused kernel.  The per-edge affine terms
    are formed here with the programs' own association —
    ``a = src_aux[scale_aux] * edge_val`` (edge_val is exactly 1.0 on real
    unweighted edges)."""
    a = src_aux[fs.scale_aux] * edge_val if fs.scale_aux else None
    b = edge_val if fs.add_edge else None
    base = dst_aux[fs.base_aux] if fs.base_aux else None
    return ops.gab_fused(fs, src_vals, a, b, dst_local, old, base, num_rows,
                         row_cap, blocks=blocks)


def tile_gather_apply_sharded(
    prog: VertexProgram,
    src_vals: Tensor,             # [E(, Q)] pre-gathered source values
    src_aux: dict[str, Tensor],   # pre-gathered per-edge aux, each [E(, ...)]
    edge_val: Tensor,             # [E]
    dst_local: Tensor,            # [E] dst - row_start; padding >= num_rows
    old: Tensor,                  # [row_cap(, Q)] this tile's current rows
    dst_aux: dict[str, Tensor],   # dst-side aux rows, each [row_cap(, ...)]
    num_rows: int,                # <= row_cap
    row_cap: int,
    seg_impl: str = "fused",
    blocks=None,
) -> tuple[Tensor, Tensor]:
    """Gather+Apply for one tile with *pre-gathered* source-side inputs —
    the out-of-core vertex-state path, and the body every in-memory step
    runs after its own gathers.

    The out-of-core engine fills ``src_vals``/``src_aux`` interval by
    interval from the :class:`~repro_torch.core.vstate.VertexStateStore`
    and slices ``old``/``dst_aux`` from the tile's own dst-interval
    block.  Edge order is untouched, so valid rows are bit-identical to
    :func:`tile_gather_apply`.  Padding slots hold zeros instead of
    ``values[0]``: their dst is at or past num_rows, and no kernel reduces
    such a row into a valid one (the segment kernel's sink row is sliced
    off, the fused kernel leaves rows past num_rows unreduced).

    Returns (new [row_cap(, Q)], updated [row_cap(, Q)] bool); rows at or
    past num_rows keep old and are not updated."""
    if seg_impl not in SEG_IMPLS:
        raise ValueError(f"seg_impl {seg_impl!r}: the port has "
                         f"{', '.join(SEG_IMPLS)}")
    fs = prog.fused_spec() if seg_impl == "fused" else None
    if fs is not None:
        return _fused_tile(fs, src_vals, src_aux, edge_val, dst_local, old,
                           dst_aux, num_rows, row_cap, blocks)
    contrib = prog.gather(src_vals, edge_val, src_aux)
    accum = segment_reduce(contrib, dst_local, row_cap + 1,
                           prog.combine, blocks=blocks)[:row_cap]
    new = prog.apply(old, accum, dst_aux)
    valid = _bcast_rows(torch.arange(row_cap, device=old.device) < num_rows,
                        new)
    new = torch.where(valid, new, old)
    return new, valid & prog.updated_mask(old, new)


def _gather_apply(prog, values, aux, src, dst_local, edge_val, old, dst_aux,
                  num_rows, row_cap, seg_impl, blocks=None):
    """Gather ``values``/``aux`` ``[V(, Q)]`` at the tile's sources, then
    :func:`tile_gather_apply_sharded` on the caller's dst rows ``old``
    ``[row_cap(, Q)]`` and ``dst_aux``."""
    src_vals = values.index_select(0, src)
    src_aux = {k: aux[k].index_select(0, src) for k in prog.src_aux}
    return tile_gather_apply_sharded(prog, src_vals, src_aux, edge_val,
                                     dst_local, old, dst_aux, num_rows,
                                     row_cap, seg_impl, blocks)


def tile_gather_apply(
    prog: VertexProgram,
    values: Tensor,               # [V(, Q)] replicated vertex values
    aux: dict[str, Tensor],       # per-vertex aux arrays, each [V(, Q)]
    src: Tensor,                  # [E] global source ids (padding -> 0)
    dst_local: Tensor,            # [E] dst - row_start; padding >= num_rows
    edge_val: Tensor,             # [E]
    row_start: int,
    num_rows: int,                # <= row_cap
    row_cap: int,
    seg_impl: str = "fused",
    blocks=None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Gather+Apply for one tile, on the device of ``values``.

    Returns (rows [row_cap] global ids clipped to V-1, new_values
    [row_cap(, Q)], updated [row_cap(, Q)] bool).  Rows beyond num_rows
    are masked not-updated."""
    nv = values.shape[0]
    rows = (row_start + torch.arange(row_cap, device=values.device)).clamp(
        max=nv - 1)
    old = values.index_select(0, rows)
    dst_aux = {k: aux[k].index_select(0, rows) for k in prog.dst_aux}
    new, updated = _gather_apply(prog, values, aux, src, dst_local, edge_val,
                                 old, dst_aux, num_rows, row_cap, seg_impl,
                                 blocks)
    return rows, new, updated


def stacked_tiles_step(prog: VertexProgram, values: Tensor,
                       aux: dict[str, Tensor], stk: dict, row_cap: int,
                       seg_impl: str = "fused",
                       blocks=None) -> tuple[Tensor, Tensor]:
    """Process a stack of tiles on the device of ``values`` (one server's
    resident tiles, or one pipelined batch): a loop over the tiles, each
    merged into padded ``[V + row_cap + 1(, Q)]`` buffers where it updated
    (tiles own disjoint row ranges).  ``stk`` holds device tensors ``src``,
    ``dst_local``, ``val`` ``[T, E]`` and host arrays ``row_start``,
    ``num_rows`` ``[T]``.

    Returns (new_masked [V(, Q)], updated [V(, Q)] bool): the updated
    value where updated, else 0."""
    nv = values.shape[0]
    pad = row_cap + 1
    values_p = _row_pad(values, pad)
    aux_p = {k: _row_pad(aux[k], pad) for k in prog.dst_aux}
    out_p = torch.zeros_like(values_p)
    upd_p = torch.zeros(values_p.shape, dtype=torch.bool,
                        device=values.device)
    for i, (r0, nr) in enumerate(zip(stk["row_start"], stk["num_rows"])):
        win = slice(int(r0), int(r0) + row_cap)
        new, updated = _gather_apply(
            prog, values, aux, stk["src"][i], stk["dst_local"][i],
            stk["val"][i], values_p[win], {k: aux_p[k][win] for k in aux_p},
            int(nr), row_cap, seg_impl, blocks)
        out_p[win] = torch.where(updated, new, out_p[win])
        upd_p[win] |= updated
    return out_p[:nv], upd_p[:nv]


def merged_server_step(prog: VertexProgram, values: Tensor,
                       aux: dict[str, Tensor], src: Tensor, dst: Tensor,
                       edge_val: Tensor, owned: Tensor,
                       seg_impl: str = "fused",
                       blocks=None) -> tuple[Tensor, Tensor]:
    """One gather/segment-reduce/apply over a server's merged edge list:
    src, dst (global, ascending), edge_val ``[E_s]`` hold every real edge
    of the server's tiles, owned ``[V]`` marks the rows its tiles cover.

    Tiles' dst ranges are disjoint and each vertex's in-edges live in one
    tile, so reducing straight into ``[V + 1]`` rows is exact; apply runs
    on every row and is masked by ownership.  ``seg_impl`` "fused" and
    "segment" both run the segment kernel here (see the module
    docstring).  Returns (new_masked [V(, Q)], updated [V(, Q)] bool)."""
    if seg_impl not in SEG_IMPLS:
        raise ValueError(f"seg_impl {seg_impl!r}: the port has "
                         f"{', '.join(SEG_IMPLS)}")
    nv = values.shape[0]
    src_vals = values.index_select(0, src)
    src_aux = {k: aux[k].index_select(0, src) for k in prog.src_aux}
    contrib = prog.gather(src_vals, edge_val, src_aux)
    accum = segment_reduce(contrib, dst, nv + 1, prog.combine,
                           blocks=blocks)[:nv]
    new = prog.apply(values, accum, {k: aux[k] for k in prog.dst_aux})
    own = _bcast_rows(owned, new)
    new = torch.where(own, new, values)
    updated = own & prog.updated_mask(values, new)
    return torch.where(updated, new, torch.zeros_like(values)), updated


def run_tile(prog, values, aux, tile_arrays, row_start, num_rows, row_cap,
             seg_impl="fused", blocks=None):
    """Out-of-core engine entry point for one tile: ``tile_arrays`` are the
    host ``(src, dst_local, edge_val)`` arrays ``[E]``, copied to the
    device of ``values`` once each.  Returns device tensors ``(rows, new,
    updated)``; the caller moves them to the host."""
    src, dst_local, edge_val = (torch.from_numpy(x).to(values.device)
                                for x in tile_arrays)
    return tile_gather_apply(prog, values, aux, src, dst_local, edge_val,
                             int(row_start), int(num_rows), row_cap,
                             seg_impl, blocks)


def run_tile_sharded(prog, src_vals, src_aux, edge_val, dst_local, old,
                     dst_aux, num_rows, row_cap, seg_impl="fused",
                     device="cuda", blocks=None):
    """Out-of-core vertex-state entry point for one tile: the host inputs
    of :func:`tile_gather_apply_sharded` (numpy arrays or CPU tensors,
    page-locked when the caller made them so) go to ``device`` with one
    non-blocking copy each.  Returns device tensors ``(new, updated)``
    ``[row_cap(, Q)]``; the caller moves them to the host."""
    def dev(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    return tile_gather_apply_sharded(
        prog, dev(src_vals), {k: dev(v) for k, v in src_aux.items()},
        dev(edge_val), dev(dst_local), dev(old),
        {k: dev(v) for k, v in dst_aux.items()}, int(num_rows), row_cap,
        seg_impl, blocks)


def stack_to_device(stk: dict, device) -> dict:
    """The device form of a ``tiles.stack_tiles`` dict for
    :func:`stacked_tiles_step`: ``src``, ``dst_local``, ``val`` ``[T, E]``
    copied to ``device``, ``row_start`` and ``num_rows`` ``[T]`` kept on
    the host (they slice the row windows)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(stk[k])).to(device)
           for k in ("src", "dst_local", "val")}
    out["row_start"] = np.asarray(stk["row_start"])
    out["num_rows"] = np.asarray(stk["num_rows"])
    return out


def run_tile_stack(prog, values, aux, stk, row_cap, seg_impl="fused",
                   blocks=None):
    """Process a K-tile stack (``tiles.stack_tiles`` output, possibly padded
    with inert tiles by ``distributed.pad_stack_to``) in one call, its edge
    arrays copied to the device of ``values`` once.

    Returns (new_masked [V(, Q)], updated [V(, Q)] bool) — per row the
    results of running ``run_tile`` over the same tiles one at a time,
    since tiles own disjoint row ranges."""
    return stacked_tiles_step(prog, values, aux,
                              stack_to_device(stk, values.device), row_cap,
                              seg_impl, blocks)
