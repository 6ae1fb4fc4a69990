"""Elastic rescale of the graph engine — the port's copy of
``remap_assignment`` and ``handoff_plan`` from ``repro/runtime/elastic.py``.

The graph engine rescales by re-running stage-2 tile assignment for the
new N — tiles are mesh-agnostic and vertex state is replicated.  The
multi-process cluster runtime (DESIGN.md §11) uses a warmth-preserving
variant: ``remap_assignment`` resizes an existing per-server tile
assignment to a new server count while keeping every tile that can stay on
its current server there, so surviving servers keep their edge caches hot
across the resize.  (The reference's ``reshard`` and
``rescale_via_checkpoint`` move jax arrays between meshes of the
language-model template: ROADMAP.md A.13.2.)
"""
from __future__ import annotations

import numpy as np


def remap_assignment(old: list[list[int]], new_n: int,
                     edges_per_tile) -> list[list[int]]:
    """Resize a per-server tile assignment to ``new_n`` servers,
    maximizing cache warmth (DESIGN.md §11).

    Tiles owned by a surviving server (old rank < ``new_n``) stay put —
    their compressed blobs are already in that server's edge cache.  Tiles
    orphaned by removed servers are placed greedily (largest edge count
    first) onto the least-edge-loaded survivor; only when the cluster
    *grows* do the new empty servers absorb work from the most-loaded
    survivors until no move improves the edge balance (on shrink the
    survivors' own tiles are never touched — that cold-rereading churn is
    exactly what this function exists to avoid).  Deterministic: ties
    break toward lower server rank and lower tile id.
    """
    if new_n < 1:
        raise ValueError("new_n must be >= 1")
    edges = np.asarray(edges_per_tile, dtype=np.int64)
    new = [list(old[s]) if s < len(old) else [] for s in range(new_n)]
    orphans = sorted((t for s in range(new_n, len(old)) for t in old[s]),
                     key=lambda t: (-edges[t], t))
    load = np.array([sum(int(edges[t]) for t in ts) for ts in new])
    for t in orphans:
        d = int(np.argmin(load))
        new[d].append(t)
        load[d] += int(edges[t])
    # growth only: drain the most-loaded survivors into the new empty
    # servers while a move strictly improves the max load
    while new_n > len(old):
        hi, lo = int(np.argmax(load)), int(np.argmin(load))
        movable = sorted(new[hi], key=lambda t: (-edges[t], t))
        best = next((t for t in movable
                     if load[lo] + edges[t] < load[hi]), None)
        if best is None:
            break
        new[hi].remove(best)
        new[lo].append(best)
        load[hi] -= int(edges[best])
        load[lo] += int(edges[best])
    return [sorted(ts) for ts in new]


def handoff_plan(old: list[list[int]], new: list[list[int]],
                 tile_bytes) -> dict:
    """Account the data movement a resize implies (DESIGN.md §12).

    For assignments ``old`` -> ``new`` over the same tile universe,
    returns ``{"moves": [(tile, src_rank, dst_rank)], "bytes": total,
    "per_dst_bytes": {dst_rank: bytes}}`` — one entry per tile whose
    owner changed, costed by ``tile_bytes[tile]`` (on-disk tile bytes:
    the new owner must fault the tile cold while survivors' unchanged
    tiles ride their warm caches; vertex state is replicated, so tiles
    are the only warmth that moves).  Tiles present only in ``new``
    (never owned before) count as moves from src ``-1``."""
    tile_bytes = np.asarray(tile_bytes, dtype=np.int64)
    src = {t: s for s, ts in enumerate(old) for t in ts}
    moves = []
    per_dst: dict[int, int] = {}
    for d, ts in enumerate(new):
        for t in ts:
            s = src.get(t, -1)
            if s != d:
                moves.append((int(t), s, d))
                per_dst[d] = per_dst.get(d, 0) + int(tile_bytes[t])
    return {"moves": moves,
            "bytes": int(sum(int(tile_bytes[t]) for t, _s, _d in moves)),
            "per_dst_bytes": per_dst}
