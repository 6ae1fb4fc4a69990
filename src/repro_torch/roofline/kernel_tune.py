"""Block tuner for the two GAB kernels on the card.

Picks ``(block_e, block_r, stack_size)`` per ``(combine, Q, edge_cap,
row_cap)`` from a dry-run cost model of the CUDA kernels
(``kernels/csrc/seg_layout.cuh``), in place of the static ``(256, 256)``
(``kernels/blocks.py``): ``block_r`` is the rows a row block owns (one
thread a row), ``block_e`` the least hub size H (a row holding two
multiples of H edges goes to the hub launch).  Every legal pair gives the
same bits, so the pick moves time only.  The model's terms:

* **bytes** — every edge streamed once (src ``[E, Q]`` + dst + one edge
  stream ``a`` or ``b``: the worst shipped case, so one pick serves every
  program at a ``(combine, Q)``), the row I/O (old, base, new, updated)
  once, over the card's HBM rate;
* **waves** of row blocks: ``ceil(row blocks / (SMs x blocks an SM
  holds))``, each at a fixed cost (``hw.ROW_WAVE_S``); an SM holds as
  many blocks as its shared memory (the edge cache of 160 bytes a row,
  the row bounds, the window table, the long-row list) and registers
  (64 a thread, ``__launch_bounds__``) and threads allow;
* **the longest row the row launch keeps**: fewer than 2H edges on one
  warp, at ``hw.EDGE_WARP_S`` an edge whatever Q (a lane loads all
  columns of an edge at once: the warp waits on the loads, not the
  bytes), the block's long rows shared by its warps (``sqrt(8 /
  warps)``: fewer warps, more rows each) — a critical path that grows
  with H;
* **the hub launch**: a tile holds at most ``E / 2H`` hubs, an R-MAT tile
  ``hw.HUB_SHARE`` of that; up to 512 groups take them one after
  another, each at a fixed cost (``hw.HUB_S``) a column pass — a term
  that shrinks as H grows.  The hub launch runs beside the row launch,
  but its fixed costs hold SMs the row blocks would use, so they add;
* **launches**: ``hw.LAUNCH_S`` each (one, two when hubs can exist).

``predicted_s = bytes + waves + hubs + longest row + launches``; the
roofline ceiling (``edges_per_s``) is ``max(bytes / HBM rate, operations /
FP32 rate)`` alone.  Feasibility is a block's shared memory and
registers on the card's table (``roofline/hw.py``), where the reference's
TPU tuner checks VMEM.  The model reads only that table, never a
run-time measurement, so the CPU and the card pick the same blocks.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.kernels.blocks import BLOCK_E, BLOCK_R, DEFAULT_BLOCKS
from repro_torch.roofline import hw

#: the kernels' static default (kernels/blocks.py)
STATIC_BLOCKS = DEFAULT_BLOCKS
#: csrc/seg_layout.cuh's constants the model reads
CACHE_BYTES_PER_ROW = 160
RESIDENT_THREADS = 1024           # __launch_bounds__: <= 64 registers
HUB_GROUPS_MAX = 512              # kHubBlocks
HUB_MAX_MULTIPLES = 16384         # kHubMaxMultiples
STACK_MAX = 16


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """One tuned kernel configuration and its model terms."""

    block_e: int
    block_r: int
    stack_size: int             # tiles per pipelined stack
    predicted_s: float          # model seconds a tile
    roofline_s: float           # max(bytes / HBM rate, ops / FP32 rate)
    edges_per_s: float          # edge_cap / roofline_s: the ceiling
    hbm_bytes: int
    flops: int                  # operations on the edge and row values
    bound: str                  # "memory" | "compute"
    smem_bytes: int             # shared memory a row block
    blocks_per_sm: int          # row blocks an SM holds
    waves: int                  # waves of row blocks
    longest_row_s: float        # the row launch's longest kept row
    hub_s: float                # the hub launch's fixed costs

    @property
    def blocks(self) -> tuple[int, int]:
        return (self.block_e, self.block_r)


def _col_chunk(q: int) -> int:
    """Columns a pass (csrc/seg_layout.cuh's col_chunk)."""
    return 1 if q == 1 else 2 if q == 2 else 4 if q <= 4 else 8


def hub_size(edge_cap: int, block_e: int) -> int:
    """H for an edge list of edge_cap: block_e doubled until the list
    holds at most HUB_MAX_MULTIPLES multiples (hub_shift())."""
    h = block_e
    while (edge_cap - 1) // h > HUB_MAX_MULTIPLES:
        h *= 2
    return h


def smem_bytes(block_r: int) -> int:
    """Shared memory of one row block: the edge cache, the row bounds
    (8 bytes a row + 1), the window table and the long-row list (4 bytes
    a row each) and the slice and counters."""
    return (CACHE_BYTES_PER_ROW * block_r + 8 * (block_r + 1)
            + 4 * block_r + 4 * block_r + 16 + 8)


def blocks_per_sm(block_r: int, smem_budget: int | None = None) -> int:
    """Row blocks an SM holds at block_r: its shared memory (of
    ``smem_budget``, default the card's), registers (64 a thread) and
    threads; 0 when one block does not fit."""
    budget = hw.SMEM_PER_SM if smem_budget is None else smem_budget
    per_block = smem_bytes(block_r)
    if per_block > hw.SMEM_PER_BLOCK:
        return 0
    by_smem = budget // (per_block + hw.SMEM_RESERVED_PER_BLOCK)
    regs = 64 * block_r
    by_regs = hw.REGS_PER_SM // regs
    by_threads = min(hw.THREADS_PER_SM, RESIDENT_THREADS) // block_r
    return int(min(by_smem, by_regs, by_threads, hw.BLOCKS_PER_SM))


def tile_cost(combine: str, q: int, edge_cap: int, row_cap: int,
              block_e: int, block_r: int, bandwidth: float | None = None,
              smem_budget: int | None = None) -> KernelChoice:
    """Model one (block_e, block_r) for one tile shape; stack_size unset
    (0)."""
    bw = hw.HBM_BW if bandwidth is None else bandwidth
    q = max(int(q), 1)
    edge_bytes = 4 * q + 4 + 4              # src, dst, one edge stream
    hbm_bytes = edge_cap * edge_bytes + row_cap * q * (4 + 4 + 4 + 1)
    flops = edge_cap * q * 2 + row_cap * q * 3
    roofline_s = max(hbm_bytes / bw, flops / hw.F32_FLOPS)

    per_sm = max(blocks_per_sm(block_r, smem_budget), 1)
    row_blocks = max(-(-row_cap // block_r), 1)
    waves = -(-row_blocks // (hw.SMS * per_sm))
    rows_s = hbm_bytes / bw + waves * hw.ROW_WAVE_S

    h = hub_size(edge_cap, block_e)
    longest = min(2 * h - 1, edge_cap)
    warps = block_r // 32
    longest_row_s = longest * hw.EDGE_WARP_S * math.sqrt(8 / warps)
    multiples = (edge_cap - 1) // h if edge_cap > h else 0
    hubs = math.ceil(edge_cap / (2 * h) * hw.HUB_SHARE) if multiples else 0
    passes = -(-q // _col_chunk(q))
    hub_s = 0.0
    if hubs:
        groups = min(multiples, HUB_GROUPS_MAX)
        hub_s = -(-hubs // groups) * passes * hw.HUB_S
    launches = 2 if multiples else 1
    predicted_s = rows_s + hub_s + longest_row_s + launches * hw.LAUNCH_S
    return KernelChoice(
        block_e=block_e, block_r=block_r, stack_size=0,
        predicted_s=predicted_s, roofline_s=roofline_s,
        edges_per_s=edge_cap / max(roofline_s, 1e-12),
        hbm_bytes=int(hbm_bytes), flops=int(flops),
        bound=("memory" if hbm_bytes / bw >= flops / hw.F32_FLOPS
               else "compute"),
        smem_bytes=smem_bytes(block_r), blocks_per_sm=per_sm, waves=waves,
        longest_row_s=longest_row_s, hub_s=hub_s)


def _stack_size(predicted_s: float) -> int:
    """Tiles per pipelined stack: enough that a stack's host dispatch
    (``hw.STACK_DISPATCH_S``) stays under ~5 % of its kernel time,
    clamped to [1, 16]."""
    k = hw.STACK_DISPATCH_S / (0.05 * max(predicted_s, 1e-9))
    return int(min(STACK_MAX, max(1, math.ceil(k))))


def candidates(edge_cap: int, row_cap: int) -> list[tuple[int, int]]:
    """The legal pairs capped at the tile's shape (a row block larger
    than the tile's rows, or a least hub size past its edges, only pads),
    in a fixed order; the static default is among them whenever it fits
    the cap."""
    be_cap = max(-(-edge_cap // 128) * 128, BLOCK_E[0])
    br_cap = max(-(-row_cap // 128) * 128, BLOCK_R[0])
    return [(be, br) for be in BLOCK_E if be <= be_cap
            for br in BLOCK_R if br <= br_cap]


def pick_blocks(combine: str, q: int, edge_cap: int, row_cap: int,
                bandwidth: float | None = None,
                smem_budget: int | None = None) -> KernelChoice:
    """The tuned (block_e, block_r, stack_size) for one (combine, Q,
    tile shape).

    Deterministic: the candidates (:func:`candidates`: capped at the
    tile's shape) are filtered by the shared memory a block needs (of
    ``smem_budget`` an SM, default the card's) and ranked by predicted
    time, ties to the static default, then the smaller block and hub
    size.  So the pick never models worse than the static default when
    that fits the tile and the budget; with no feasible candidate it
    falls back to the smallest legal pair."""
    cands = [tile_cost(combine, q, edge_cap, row_cap, be, br,
                       bandwidth=bandwidth, smem_budget=smem_budget)
             for be, br in candidates(edge_cap, row_cap)
             if blocks_per_sm(br, smem_budget) >= 1]
    if not cands:  # degenerate budget: the smallest legal pair
        cands = [tile_cost(combine, q, edge_cap, row_cap, BLOCK_E[0],
                           BLOCK_R[0], bandwidth=bandwidth,
                           smem_budget=smem_budget)]
    best = min(cands, key=lambda c: (c.predicted_s,
                                     c.blocks != STATIC_BLOCKS, c.block_r,
                                     c.block_e))
    return dataclasses.replace(best, stack_size=_stack_size(best.predicted_s))
