"""Stack padding helpers of the distributed GAB path (numpy only).

The port's copies of ``repro/core/distributed.py:pad_tile_count``,
``make_empty_tile_arrays`` and ``pad_stack_to``: the pipelined engine pads
a short batch of tiles with inert ones.  The reference module imports jax
for its mesh path, so the port keeps its own copy; the mesh collectives
and the cluster exchange are ROADMAP.md queue A.8 and A.9.
"""
from __future__ import annotations

import numpy as np


def pad_tile_count(num_tiles: int, num_shards: int) -> int:
    """Round ``num_tiles`` up to a multiple of ``num_shards``."""
    return ((num_tiles + num_shards - 1) // num_shards) * num_shards


def make_empty_tile_arrays(stk: dict) -> dict:
    """An inert tile: every edge points at the global sink row, zero rows."""
    ecap, rcap = stk["edge_cap"], stk["row_cap"]
    return dict(
        src=np.zeros((1, ecap), np.int32),
        dst_local=np.full((1, ecap), rcap, np.int32),
        val=np.zeros((1, ecap), np.float32),
        row_start=np.zeros((1,), np.int32),
        num_rows=np.zeros((1,), np.int32),
        num_edges=np.zeros((1,), np.int32),
    )


def pad_stack_to(stk: dict, total: int) -> dict:
    """Pad a ``stack_tiles`` dict along the tile axis to exactly ``total``
    tiles using inert tiles (all edges at the sink row, zero rows).  Padding
    changes no per-row result — the pipelined engine uses it to keep every
    batch ``stack_size`` tiles long."""
    pad = total - len(stk["row_start"])
    if pad > 0:
        empty = make_empty_tile_arrays(stk)
        for k in ("src", "dst_local", "val", "row_start", "num_rows",
                  "num_edges"):
            stk[k] = np.concatenate([stk[k]] + [empty[k]] * pad, axis=0)
    return stk
