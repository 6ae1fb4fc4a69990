"""Tile data structures — GraphH's basic graph-processing unit (paper §III-B).

A *tile* holds a contiguous target-vertex (row) range of the |V|x|V|
adjacency matrix with ~S = |E|/P edges, in an "enhanced CSR" layout.

TPU adaptation: XLA wants static shapes, so a tile is materialized as a
*padded sorted-COO* block (`src`, `dst_local`, `val`) of fixed capacity
``edge_cap`` plus a fixed row capacity ``row_cap``.  Padding edges point at a
sink row (index ``row_cap``) so they are algebraically inert for any
monoid with an identity element — no masks needed in the hot loop.  The CSR
``row_ptr`` is kept as well for the scalar-prefetch kernel variant and for
host-side analytics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Sink-row convention: padded edges use dst_local == num_rows(tile) and the
# output buffer has row_cap + 1 rows; the last row is discarded.


@dataclasses.dataclass
class TileMeta:
    """Host-side metadata for one tile (cheap to keep resident)."""

    tile_id: int
    row_start: int          # first target vertex id covered by this tile
    row_end: int            # one past the last target vertex id
    num_edges: int          # real (un-padded) edge count
    edge_cap: int           # padded edge capacity (static shape)
    row_cap: int            # padded row capacity (static shape)
    weighted: bool
    # --- source-interval footprint (DESIGN.md §10; None when the store was
    # built without an interval plan — the engine then computes it lazily) ---
    # interval ids this tile's real src ids touch, ascending
    src_intervals: Optional[tuple] = None
    # cumulative real-edge counts per footprint interval
    # (len == len(src_intervals) + 1); together with Tile.iv_perm these let
    # gather run interval-by-interval over contiguous slices
    src_interval_ptr: Optional[tuple] = None

    @property
    def num_rows(self) -> int:
        """Target rows this tile owns (row_end - row_start)."""
        return self.row_end - self.row_start

    def to_dict(self) -> dict:
        """JSON-serializable form (embedded in the tile blob header)."""
        d = dataclasses.asdict(self)
        if self.src_intervals is not None:
            d["src_intervals"] = list(self.src_intervals)
            d["src_interval_ptr"] = list(self.src_interval_ptr)
        return d

    @staticmethod
    def from_dict(d: dict) -> "TileMeta":
        """Inverse of ``to_dict``."""
        d = dict(d)
        for key in ("src_intervals", "src_interval_ptr"):
            if d.get(key) is not None:
                d[key] = tuple(int(x) for x in d[key])
        return TileMeta(**d)


@dataclasses.dataclass
class Tile:
    """One tile: metadata + padded edge arrays.

    Arrays (all length ``edge_cap`` unless noted):
      src        int32 — global source vertex id (0 for padding)
      dst_local  int32 — target vertex id minus row_start; padding = num_rows
      val        float32 — edge value; absent (None) for unweighted graphs
      row_ptr    int32[num_rows + 1] — CSR offsets into the un-padded prefix
      iv_perm    int32[num_edges] — edge indices bucket-sorted by source
                 interval (stable), or None when no footprint is attached;
                 slice j of ``meta.src_interval_ptr`` selects the edges whose
                 src lives in ``meta.src_intervals[j]``
    """

    meta: TileMeta
    src: np.ndarray
    dst_local: np.ndarray
    val: Optional[np.ndarray]
    row_ptr: np.ndarray
    iv_perm: Optional[np.ndarray] = None

    def nbytes(self) -> int:
        """Uncompressed in-memory array bytes (excludes metadata)."""
        n = self.src.nbytes + self.dst_local.nbytes + self.row_ptr.nbytes
        if self.val is not None:
            n += self.val.nbytes
        return n

    def source_ids(self) -> np.ndarray:
        """Unique real source vertex ids ``[U]`` (for bloom filters / skip
        bitmaps)."""
        return np.unique(self.src[: self.meta.num_edges])

    def validate(self) -> None:
        """Assert every structural invariant (shapes, CSR sort order, padding
        sink rows, footprint consistency) — test/debug aid."""
        m = self.meta
        assert self.src.shape == (m.edge_cap,), (self.src.shape, m.edge_cap)
        assert self.dst_local.shape == (m.edge_cap,)
        assert self.row_ptr.shape == (m.num_rows + 1,)
        assert self.row_ptr[0] == 0 and self.row_ptr[-1] == m.num_edges
        real_dst = self.dst_local[: m.num_edges]
        if m.num_edges:
            assert real_dst.min() >= 0 and real_dst.max() < m.num_rows
            # sorted by target row (CSR invariant)
            assert np.all(np.diff(real_dst) >= 0)
        pad = self.dst_local[m.num_edges :]
        if pad.size:
            assert np.all(pad == m.num_rows)
        if self.val is not None:
            assert self.val.shape == (m.edge_cap,)
        if self.iv_perm is not None:
            assert m.src_intervals is not None and m.src_interval_ptr is not None
            assert self.iv_perm.shape == (m.num_edges,)
            assert len(m.src_interval_ptr) == len(m.src_intervals) + 1
            assert m.src_interval_ptr[0] == 0
            assert m.src_interval_ptr[-1] == m.num_edges


def compute_source_footprint(
    src: np.ndarray, num_edges: int, interval_splitter: np.ndarray
) -> tuple[tuple, tuple, np.ndarray]:
    """Source-interval footprint of a tile's real edges src ``[E]`` under
    interval_splitter ``[K+1]``.

    Returns (interval ids ascending, cumulative edge counts per interval,
    edge-index permutation ``[E]`` bucket-sorting the real edges by
    interval) — the
    layout gather needs to run interval-by-interval with one contiguous
    block read per touched interval."""
    real = np.asarray(src[:num_edges], dtype=np.int64)
    if num_edges == 0:
        return (), (0,), np.zeros(0, dtype=np.int32)
    iv = np.searchsorted(np.asarray(interval_splitter, dtype=np.int64),
                         real, side="right") - 1
    perm = np.argsort(iv, kind="stable").astype(np.int32)
    ids, counts = np.unique(iv, return_counts=True)
    ptr = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return (tuple(int(i) for i in ids), tuple(int(p) for p in ptr), perm)


def attach_source_footprint(tile: Tile, interval_splitter: np.ndarray) -> Tile:
    """Record the tile's source-interval footprint (interval_splitter
    ``[K+1]``) in its metadata (and the bucket-sort permutation in
    ``iv_perm``).  In place; returns the tile."""
    ids, ptr, perm = compute_source_footprint(
        tile.src, tile.meta.num_edges, interval_splitter)
    tile.meta.src_intervals = ids
    tile.meta.src_interval_ptr = ptr
    tile.iv_perm = perm
    tile.validate()
    return tile


def build_tile(
    tile_id: int,
    row_start: int,
    row_end: int,
    src: np.ndarray,
    dst: np.ndarray,
    val: Optional[np.ndarray],
    edge_cap: int,
    row_cap: int,
    interval_splitter: Optional[np.ndarray] = None,
) -> Tile:
    """Build a padded tile from raw (src ``[E]``, dst ``[E]``[, val
    ``[E]``]) edges with
    row_start <= dst < row_end.  Edges are sorted by (dst, src).  When an
    ``interval_splitter`` is given, the source-interval footprint is
    recorded in the tile's metadata (DESIGN.md §10)."""
    num_edges = int(src.shape[0])
    num_rows = row_end - row_start
    if num_edges > edge_cap:
        raise ValueError(f"tile {tile_id}: {num_edges} edges > edge_cap {edge_cap}")
    if num_rows > row_cap:
        raise ValueError(f"tile {tile_id}: {num_rows} rows > row_cap {row_cap}")

    dst_local = (dst - row_start).astype(np.int32)
    order = np.lexsort((src, dst_local))
    src = src[order].astype(np.int32)
    dst_local = dst_local[order]
    if val is not None:
        val = val[order].astype(np.float32)

    # CSR row pointers over the un-padded prefix.
    counts = np.bincount(dst_local, minlength=num_rows).astype(np.int64)
    row_ptr = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])

    # Pad to capacity: sink row, src 0, val 0.
    pad = edge_cap - num_edges
    src_p = np.concatenate([src, np.zeros(pad, dtype=np.int32)])
    dst_p = np.concatenate([dst_local, np.full(pad, num_rows, dtype=np.int32)])
    val_p = None
    if val is not None:
        val_p = np.concatenate([val, np.zeros(pad, dtype=np.float32)])

    meta = TileMeta(
        tile_id=tile_id,
        row_start=int(row_start),
        row_end=int(row_end),
        num_edges=num_edges,
        edge_cap=int(edge_cap),
        row_cap=int(row_cap),
        weighted=val is not None,
    )
    t = Tile(meta=meta, src=src_p, dst_local=dst_p, val=val_p, row_ptr=row_ptr)
    if interval_splitter is not None:
        return attach_source_footprint(t, interval_splitter)
    t.validate()
    return t


def tile_edge_values(tile: Tile) -> np.ndarray:
    """Edge-value array ``[E]`` (E = edge_cap) with inert padding: real val
    (or 1.0 if unweighted), 0.0 for padded slots."""
    if tile.val is not None:
        return tile.val
    v = np.zeros(tile.meta.edge_cap, dtype=np.float32)
    v[: tile.meta.num_edges] = 1.0
    return v


def stack_tiles(tiles: list[Tile], row_cap: int) -> dict:
    """Stack equally-shaped tiles into dense arrays for scan-based processing.

    dst_local is re-padded so every tile uses the *global* sink row
    ``row_cap`` (not its own num_rows) — all tiles then share one output
    shape [row_cap + 1].

    Returns dict of arrays with leading dim = len(tiles):
      src[i, E], dst_local[i, E], val[i, E] (zeros if unweighted),
      row_start[i], num_rows[i], num_edges[i]
    """
    assert tiles, "stack_tiles needs at least one tile"
    ecap = tiles[0].meta.edge_cap
    for t in tiles:
        assert t.meta.edge_cap == ecap, "all tiles must share edge_cap"
        assert t.meta.num_rows <= row_cap
    n = len(tiles)
    src = np.zeros((n, ecap), dtype=np.int32)
    dstl = np.full((n, ecap), row_cap, dtype=np.int32)
    val = np.zeros((n, ecap), dtype=np.float32)
    row_start = np.zeros((n,), dtype=np.int32)
    num_rows = np.zeros((n,), dtype=np.int32)
    num_edges = np.zeros((n,), dtype=np.int32)
    for i, t in enumerate(tiles):
        m = t.meta
        src[i] = t.src
        d = t.dst_local.copy()
        d[m.num_edges :] = row_cap          # re-point padding at global sink
        dstl[i] = d
        if t.val is not None:
            val[i] = t.val
        else:
            val[i, : m.num_edges] = 1.0     # unweighted => implicit weight 1
        row_start[i] = m.row_start
        num_rows[i] = m.num_rows
        num_edges[i] = m.num_edges
    return dict(
        src=src,
        dst_local=dstl,
        val=val,
        row_start=row_start,
        num_rows=num_rows,
        num_edges=num_edges,
        row_cap=row_cap,
        edge_cap=ecap,
    )
