"""SPE — graph pre-processing engine (paper §III-B, Algorithm 4).

The paper runs three Spark map-reduce jobs; here the same three passes run
as chunked out-of-core host passes (this is a data-plane component — Spark
itself contributes nothing algorithmic):

  pass 1+2: per-chunk bincount map -> added reduce  => out-degree, in-degree
  splitter: walk the in-degree array, cut a tile every S edges
  pass 3  : shuffle edges into per-tile spill buckets (group-by tile id),
            then build each tile's CSR block and write it to the store.

The edge stream can be replayed (callable returning a fresh iterator), so
nothing is ever fully materialized in memory.
"""
from __future__ import annotations

import os
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.core.partition import (IntervalPlan, PartitionPlan, plan_intervals,
                                  plan_partition)
from repro_torch.core.tiles import build_tile
from repro_torch.graphio.formats import TileStore
from repro_torch.graphio.synth import EdgeChunk, ordered_map

StreamFactory = Callable[[], Iterator[EdgeChunk]]


def degree_pass(stream: Iterator[EdgeChunk], num_vertices: int) -> tuple[np.ndarray, np.ndarray]:
    """Map-reduce jobs 1+2: out-degree and in-degree in one pass."""
    out_deg = np.zeros(num_vertices, dtype=np.int64)
    in_deg = np.zeros(num_vertices, dtype=np.int64)
    for src, dst, _ in stream:
        out_deg += np.bincount(src, minlength=num_vertices)
        in_deg += np.bincount(dst, minlength=num_vertices)
    return in_deg, out_deg


class _SpillBuckets:
    """Append-only per-tile spill files for the shuffle pass."""

    def __init__(self, root: str, num_tiles: int, weighted: bool):
        self.root = root
        self.weighted = weighted
        os.makedirs(root, exist_ok=True)
        self.paths = [os.path.join(root, f"spill{t:06d}.bin") for t in range(num_tiles)]
        self.files = [open(p, "wb") for p in self.paths]
        self.rec = np.dtype(
            [("src", "<i8"), ("dst", "<i8")] + ([("val", "<f4")] if weighted else [])
        )

    def append(self, tile_ids: np.ndarray, src: np.ndarray, dst: np.ndarray,
               val: Optional[np.ndarray]) -> None:
        order = np.argsort(tile_ids, kind="stable")
        tile_ids = tile_ids[order]
        src, dst = src[order], dst[order]
        if val is not None:
            val = val[order]
        bounds = np.searchsorted(tile_ids, np.arange(len(self.files) + 1))
        for t in np.unique(tile_ids):
            lo, hi = bounds[t], bounds[t + 1]
            rec = np.empty(hi - lo, dtype=self.rec)
            rec["src"] = src[lo:hi]
            rec["dst"] = dst[lo:hi]
            if val is not None:
                rec["val"] = val[lo:hi]
            self.files[t].write(rec.tobytes())

    def read(self, t: int) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        self.files[t].flush()
        rec = np.fromfile(self.paths[t], dtype=self.rec)
        return (
            rec["src"].astype(np.int64),
            rec["dst"].astype(np.int64),
            rec["val"].astype(np.float32) if self.weighted else None,
        )

    def close(self, remove: bool = True) -> None:
        for f in self.files:
            f.close()
        if remove:
            for p in self.paths:
                if os.path.exists(p):
                    os.remove(p)


def preprocess(
    stream_factory: StreamFactory,
    num_vertices: int,
    store: TileStore,
    tile_size: int,
    weighted: bool = False,
    dedup: bool = False,
    pad_edges_to: int = 128,
    pad_rows_to: int = 8,
    num_intervals: int = 0,
    threads: int = 1,
) -> PartitionPlan:
    """Run the full SPE pipeline into ``store``.  Returns the partition plan.

    ``num_intervals > 0`` additionally derives a source-interval plan
    (DESIGN.md §10), records each tile's source-interval footprint in its
    metadata (versioned GHT2 tile format), and persists the interval plan
    in the store's meta.json for the out-of-core vertex-state engine.

    ``threads > 1`` builds tiles on a thread pool (numpy releases the GIL
    in its sorts and scans), at most ``2 * threads`` ahead of the writer,
    which writes them in tile order: the store's bytes do not change."""
    in_deg, out_deg = degree_pass(stream_factory(), num_vertices)
    plan = plan_partition(in_deg, tile_size, pad_edges_to, pad_rows_to)
    iv_plan: Optional[IntervalPlan] = (
        plan_intervals(plan.splitter, num_intervals) if num_intervals else None)

    spill_root = os.path.join(store.root, "_spill")
    buckets = _SpillBuckets(spill_root, plan.num_tiles, weighted)
    try:
        for src, dst, val in stream_factory():
            tids = (np.searchsorted(plan.splitter, dst, side="right") - 1).astype(np.int64)
            buckets.append(tids, src, dst, val)

        store.initialize(plan, weighted, in_deg, out_deg,
                         interval_plan=iv_plan)
        dd_in = np.zeros_like(in_deg) if dedup else None
        dd_out = np.zeros_like(out_deg) if dedup else None

        def one(t):
            src, dst, val = buckets.read(t)
            lo, hi = plan.tile_range(t)
            if dedup and len(src):
                key = src * (plan.num_vertices + 1) + dst
                _, idx = np.unique(key, return_index=True)
                src, dst = src[idx], dst[idx]
                val = val[idx] if val is not None else None
            tile = build_tile(
                t, lo, hi, src, dst, val if weighted else None,
                plan.edge_cap, plan.row_cap,
                interval_splitter=None if iv_plan is None else iv_plan.splitter,
            )
            return tile, src, dst

        for tile, src, dst in ordered_map(one, plan.num_tiles, threads):
            if dedup:
                dd_in += np.bincount(dst, minlength=len(in_deg))
                dd_out += np.bincount(src, minlength=len(out_deg))
            store.write_tile(tile)
        if dedup:   # degrees must reflect the deduped edge set
            store.initialize(plan, weighted, dd_in, dd_out,
                             interval_plan=iv_plan)
    finally:
        buckets.close()
        if os.path.isdir(spill_root) and not os.listdir(spill_root):
            os.rmdir(spill_root)
    return plan


def preprocess_arrays(
    src: np.ndarray, dst: np.ndarray, val: Optional[np.ndarray],
    num_vertices: int, store: TileStore, tile_size: int, **kw,
) -> PartitionPlan:
    """In-memory convenience wrapper over ``preprocess`` for edge arrays
    (src/dst int64 [E], optional float32 val [E])."""
    from repro_torch.graphio.synth import from_arrays

    return preprocess(
        lambda: from_arrays(src, dst, val),
        num_vertices, store, tile_size,
        weighted=val is not None, **kw,
    )
