"""Interval-sharded out-of-core vertex state (DESIGN.md §10).

GraphH's All-in-All policy keeps the full ``[V(, Q)]`` value/aux arrays
resident on every server — the one remaining memory wall once edges
stream from disk.  GraphD and DFOGraph (PAPERS.md) go *fully* out of
core: vertex state is split into intervals and spilled to disk, so the
vertex footprint alone may exceed RAM.  This module is that layer.

V is cut into K contiguous *source intervals* aligned to tile row ranges
(``partition.plan_intervals``).  Every registered array ("value" plus the
program's aux arrays) is sharded into one block per interval, and blocks
move through the same hot/warm/cold ladder as the edge cache
(``cache.TIER_LADDER``):

    tier   representation                      cost to touch
    hot    resident ndarray                    zero
    warm   zstd-1 blob in memory               decompress
    cold   zstd-9 blob spilled to a disk file  read + decompress

A byte budget bounds hot + warm bytes; the cold tier is disk and
unbounded — this is what opens the "vertex set bigger than RAM"
scenario.  Demotion is clean-block-aware: a block whose warm blob or
spill file is still current is demoted by just dropping the hotter
representation (no codec, no write); only *dirty* blocks — written since
their last serialization — pay compression and disk writes on the way
down (the dirty-writeback-only invariant, tested in tests/test_vstate.py).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.core.cache import TIER_LADDER
from repro_torch.graphio import formats

# warm = admission blob (zstd-1 analogue), cold = on-disk spill (zstd-9)
WARM_MODE = TIER_LADDER[1]
COLD_MODE = TIER_LADDER[2]


class VStateStats:
    """Counters are cumulative over the store's lifetime; the engine reports
    per-superstep deltas (like the edge-cache stats)."""

    def __init__(self) -> None:
        self.hits = 0                 # get_block served from the hot tier
        self.faults = 0               # get_block had to decode (warm + cold)
        self.warm_faults = 0
        self.cold_faults = 0
        self.load_bytes = 0           # compressed bytes decoded on faults
        self.spills = 0               # blocks written to the disk tier
        self.spill_bytes = 0          # compressed bytes written to disk
        self.dirty_writebacks = 0     # write_block calls (state mutations)
        self.compress_seconds = 0.0
        self.decompress_seconds = 0.0
        self.disk_seconds = 0.0

    def as_dict(self) -> dict:
        """Plain-dict snapshot (for logs/benchmark JSON)."""
        return dict(
            hits=self.hits, faults=self.faults,
            warm_faults=self.warm_faults, cold_faults=self.cold_faults,
            load_bytes=self.load_bytes, spills=self.spills,
            spill_bytes=self.spill_bytes,
            dirty_writebacks=self.dirty_writebacks,
            compress_seconds=self.compress_seconds,
            decompress_seconds=self.decompress_seconds,
            disk_seconds=self.disk_seconds,
        )


@dataclasses.dataclass
class _Block:
    """One interval of one array.  Representations, newest first:
    ``arr`` (hot) > ``blob`` (warm, current iff not None) > spill file
    (current iff ``file_ok``).  ``write_block`` invalidates the colder
    copies; demotion reuses a still-current colder copy for free."""

    name: str
    k: int
    shape: tuple
    dtype: np.dtype
    arr: Optional[np.ndarray] = None
    blob: Optional[bytes] = None
    file_ok: bool = False
    #: content version — bumped on every mutation (write_block /
    #: compact_columns).  The graph checkpointer keys its incremental
    #: "unchanged block -> hardlink" decision on this counter.
    version: int = 0

    @property
    def raw_bytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize

    def mem_bytes(self) -> int:
        n = 0
        if self.arr is not None:
            n += self.arr.nbytes
        if self.blob is not None:
            n += len(self.blob)
        return n


class VertexStateStore:
    """Interval-sharded container for the engine's per-vertex arrays.

    ``get_block`` returns the hot ndarray for one interval (callers must
    treat it as read-only); ``write_block`` replaces an interval's content
    and marks it dirty.  ``budget_bytes=None`` disables spilling entirely
    (everything stays hot) — the engine only builds a store when a budget
    is set, but unit tests use the unlimited mode as the oracle."""

    #: lock discipline, enforced by tools/analyze.py --check locks
    _guarded_by = {"_blocks": "_lock", "_specs": "_lock",
                   "_mem": "_lock", "stats": "_lock"}

    def __init__(self, splitter: np.ndarray,
                 budget_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self.splitter = np.asarray(splitter, dtype=np.int64)
        assert len(self.splitter) >= 2
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        self.spill_dir = spill_dir
        self.stats = VStateStats()
        self._blocks: OrderedDict[tuple[str, int], _Block] = OrderedDict()
        self._specs: dict[str, tuple[np.dtype, tuple]] = {}  # name -> (dtype, tail)
        self._mem = 0
        self._lock = threading.RLock()

    # -- geometry -----------------------------------------------------------
    @property
    def num_intervals(self) -> int:
        """K = number of vertex intervals."""
        return len(self.splitter) - 1

    @property
    def num_vertices(self) -> int:
        """V = total vertices covered by the splitter."""
        return int(self.splitter[-1])

    def interval_range(self, k: int) -> tuple[int, int]:
        """[lo, hi) vertex range of interval ``k``."""
        return int(self.splitter[k]), int(self.splitter[k + 1])

    def interval_of(self, vertex_ids) -> np.ndarray:
        """Owning interval id ``[U]`` per vertex id ``[U]`` (vectorized
        searchsorted)."""
        return np.searchsorted(self.splitter, vertex_ids, side="right") - 1

    # -- registration / access ----------------------------------------------
    def add_array(self, name: str, arr: np.ndarray) -> None:
        """Shard a full ``[V(, Q)]`` array into interval blocks.  Blocks
        start hot; budget enforcement may immediately demote/spill the tail
        (the "initial state lives on disk" case)."""
        arr = np.asarray(arr)
        assert arr.shape[0] == self.num_vertices, (arr.shape, self.num_vertices)
        with self._lock:
            self._specs[name] = (arr.dtype, arr.shape[1:])
            for k in range(self.num_intervals):
                lo, hi = self.interval_range(k)
                blk = _Block(name=name, k=k, shape=(hi - lo,) + arr.shape[1:],
                             dtype=arr.dtype,
                             arr=np.ascontiguousarray(arr[lo:hi]))
                self._blocks[(name, k)] = blk
                self._mem += blk.mem_bytes()
            self._enforce_budget()

    def spec(self, name: str) -> tuple[np.dtype, tuple]:
        """(dtype, trailing shape) of a registered array."""
        with self._lock:
            return self._specs[name]

    def names(self) -> tuple[str, ...]:
        """Registered array names ("value" + the program's aux arrays)."""
        with self._lock:
            return tuple(self._specs)

    def get_block(self, name: str, k: int) -> np.ndarray:
        """Interval ``k`` of array ``name`` as a hot ndarray ``[B(, Q)]``
        (B = interval rows; read-only by convention — use ``write_block``
        to mutate)."""
        with self._lock:
            b = self._blocks[(name, k)]
            self._blocks.move_to_end((name, k))
            if b.arr is not None:
                self.stats.hits += 1
                return b.arr
            self.stats.faults += 1
            if b.blob is not None:
                self.stats.warm_faults += 1
                self.stats.load_bytes += len(b.blob)
                t0 = time.perf_counter()
                raw = formats.decompress_blob(b.blob, WARM_MODE)
                self.stats.decompress_seconds += time.perf_counter() - t0
            else:
                assert b.file_ok, f"block {(name, k)} has no representation"
                self.stats.cold_faults += 1
                t0 = time.perf_counter()
                with open(self._path(b), "rb") as f:
                    fb = f.read()
                self.stats.disk_seconds += time.perf_counter() - t0
                self.stats.load_bytes += len(fb)
                t0 = time.perf_counter()
                raw = formats.decompress_blob(fb, COLD_MODE)
                self.stats.decompress_seconds += time.perf_counter() - t0
            b.arr = np.frombuffer(raw, dtype=b.dtype).reshape(b.shape).copy()
            self._mem += b.arr.nbytes
            self._enforce_budget(exclude=(name, k))
            return b.arr

    def write_block(self, name: str, k: int, arr: np.ndarray) -> None:
        """Replace interval ``k``'s content with arr ``[B(, Q)]`` — the
        dirty-writeback entry
        point.  Invalidates the warm/cold copies, so the block pays
        (re)serialization only when pressure later demotes it."""
        with self._lock:
            b = self._blocks[(name, k)]
            assert arr.shape == b.shape and arr.dtype == b.dtype, \
                (arr.shape, b.shape, arr.dtype, b.dtype)
            self._mem -= b.mem_bytes()
            b.arr = np.ascontiguousarray(arr)
            b.blob = None
            b.file_ok = False
            b.version += 1
            self._mem += b.mem_bytes()
            self._blocks.move_to_end((name, k))
            self.stats.dirty_writebacks += 1
            self._enforce_budget(exclude=(name, k))

    def materialize(self, name: str) -> np.ndarray:
        """Assemble the full array ``[V(, Q)]`` (used once, when a run
        finishes)."""
        return np.concatenate(
            [self.get_block(name, k) for k in range(self.num_intervals)])

    def compact_columns(self, names: list[str], keep: np.ndarray) -> None:
        """Multi-query retirement support: drop query columns (trailing-axis
        selection) from ``[V, Q]`` arrays, block by block."""
        keep = np.asarray(keep)
        with self._lock:
            for name in names:
                dt, tail = self._specs[name]
                assert len(tail) == 1, f"{name} has no query axis"
                self._specs[name] = (dt, (int(keep.sum()),))
                for k in range(self.num_intervals):
                    cur = self.get_block(name, k)
                    b = self._blocks[(name, k)]
                    self._mem -= b.mem_bytes()
                    b.arr = np.ascontiguousarray(cur[:, keep])
                    b.shape = b.arr.shape
                    b.blob = None
                    b.file_ok = False
                    b.version += 1
                    self._mem += b.mem_bytes()
            self._enforce_budget()

    def append_columns(self, cols: dict[str, np.ndarray]) -> None:
        """Multi-query admission support (DESIGN.md §13): splice fresh query
        columns onto the trailing axis of ``[V, Q]`` arrays, block by block.

        The inverse of ``compact_columns`` — but tier-preserving: each block
        is re-encoded *at its current tier* (hot blocks concat in memory;
        warm blobs decompress → concat → recompress warm; cold spill files
        are rewritten in place at cold mode) so admitting a query never
        promotes cold state into the byte budget.  ``cols`` maps array name
        to the ``[V, q_new]`` columns to append; every name must already be
        registered with a 1-D query tail."""
        with self._lock:
            for name, new in cols.items():
                new = np.asarray(new)
                dt, tail = self._specs[name]
                assert len(tail) == 1, f"{name} has no query axis"
                assert new.ndim == 2 and new.shape[0] == self.num_vertices, \
                    (name, new.shape, self.num_vertices)
                new = np.ascontiguousarray(new, dtype=dt)
                self._specs[name] = (dt, (int(tail[0]) + new.shape[1],))
                for k in range(self.num_intervals):
                    lo, hi = self.interval_range(k)
                    piece = new[lo:hi]
                    b = self._blocks[(name, k)]
                    self._mem -= b.mem_bytes()
                    if b.arr is not None:
                        b.arr = np.ascontiguousarray(
                            np.concatenate([b.arr, piece], axis=1))
                        b.shape = b.arr.shape
                        b.blob = None
                        b.file_ok = False
                    elif b.blob is not None:
                        t0 = time.perf_counter()
                        raw = formats.decompress_blob(b.blob, WARM_MODE)
                        self.stats.decompress_seconds += (
                            time.perf_counter() - t0)
                        cur = np.frombuffer(raw, dtype=b.dtype).reshape(b.shape)
                        cur = np.ascontiguousarray(
                            np.concatenate([cur, piece], axis=1))
                        b.shape = cur.shape
                        t0 = time.perf_counter()
                        b.blob = formats.compress_blob(cur.tobytes(), WARM_MODE)
                        self.stats.compress_seconds += (
                            time.perf_counter() - t0)
                        b.file_ok = False
                    else:
                        assert b.file_ok, \
                            f"block {(name, k)} has no representation"
                        t0 = time.perf_counter()
                        with open(self._path(b), "rb") as f:
                            fb = f.read()
                        self.stats.disk_seconds += time.perf_counter() - t0
                        t0 = time.perf_counter()
                        raw = formats.decompress_blob(fb, COLD_MODE)
                        self.stats.decompress_seconds += (
                            time.perf_counter() - t0)
                        cur = np.frombuffer(raw, dtype=b.dtype).reshape(b.shape)
                        cur = np.ascontiguousarray(
                            np.concatenate([cur, piece], axis=1))
                        b.shape = cur.shape
                        self._spill(b, cur.tobytes())
                    b.version += 1
                    self._mem += b.mem_bytes()
            self._enforce_budget()

    # -- checkpoint support (DESIGN.md §12) ----------------------------------
    def block_version(self, name: str, k: int) -> int:
        """Content version of one block — bumped on every mutation, so an
        unchanged version between two checkpoints means identical bytes
        (the checkpointer then hardlinks instead of re-serializing)."""
        with self._lock:
            return self._blocks[(name, k)].version

    def export_block(self, name: str, k: int) -> tuple[int, bytes]:
        """(compression mode, blob) for one block, reusing the *coldest
        already-current* representation — a clean spilled block's file
        bytes ship as-is (no recompression), a warm blob ships as-is,
        and only a dirty hot block pays one warm-mode compression.  Pure
        read: block state, tiers and budget accounting are untouched."""
        with self._lock:
            b = self._blocks[(name, k)]
            if b.file_ok:
                with open(self._path(b), "rb") as f:
                    return COLD_MODE, f.read()
            if b.blob is not None:
                return WARM_MODE, b.blob
            assert b.arr is not None, f"block {(name, k)} has no representation"
            return WARM_MODE, formats.compress_blob(b.arr.tobytes(), WARM_MODE)

    # -- introspection -------------------------------------------------------
    def resident_bytes(self) -> int:
        """Current in-memory bytes across hot ndarrays + warm blobs."""
        with self._lock:
            return self._mem

    def hot_intervals(self, name: str = "value") -> set[int]:
        """Intervals whose ``name`` block is in the hot tier right now —
        the scheduler's joint-residency signal."""
        with self._lock:
            return {k for (n, k), b in self._blocks.items()
                    if n == name and b.arr is not None}

    def hot_block_capacity(self, name: str = "value") -> int:
        """~How many ``name`` blocks fit hot under the budget (>= 1)."""
        if self.budget_bytes is None:
            return self.num_intervals
        with self._lock:
            per = max(1, max((self._blocks[(name, k)].raw_bytes
                              for k in range(self.num_intervals)), default=1))
        return max(1, self.budget_bytes // per)

    def tier_snapshot(self) -> dict:
        """Per-tier {blocks, bytes} residency snapshot (hot/warm/cold)."""
        with self._lock:
            out = dict(hot=dict(blocks=0, bytes=0),
                       warm=dict(blocks=0, bytes=0),
                       cold=dict(blocks=0, bytes=0))
            for b in self._blocks.values():
                if b.arr is not None:
                    out["hot"]["blocks"] += 1
                    out["hot"]["bytes"] += b.arr.nbytes
                elif b.blob is not None:
                    out["warm"]["blocks"] += 1
                    out["warm"]["bytes"] += len(b.blob)
                else:
                    out["cold"]["blocks"] += 1
            return out

    def close(self) -> None:
        """Remove spill files (the store is per-run scratch state).  A
        store without a spill_dir never touched disk — nothing to do."""
        if self.spill_dir is None:
            return
        with self._lock:
            for b in self._blocks.values():
                p = self._path(b)
                if os.path.exists(p):
                    os.remove(p)
                b.file_ok = False
            if (os.path.isdir(self.spill_dir)
                    and not os.listdir(self.spill_dir)):
                os.rmdir(self.spill_dir)

    # -- internals -----------------------------------------------------------
    def _path(self, b: _Block) -> str:
        assert self.spill_dir is not None, \
            "VertexStateStore needs a spill_dir to use the cold tier"
        return os.path.join(self.spill_dir, f"{b.name}.{b.k}.blk")

    def _enforce_budget(self, exclude: Optional[tuple] = None) -> None:
        """Demote LRU blocks down the ladder until hot+warm fits the budget.
        The just-touched block is excluded so a gather can always hold its
        current interval hot, even when one block exceeds the budget."""
        if self.budget_bytes is None:
            return
        while self._mem > self.budget_bytes:
            victim = None
            for key, b in self._blocks.items():   # LRU first
                if key != exclude and b.mem_bytes() > 0:
                    victim = b
                    break
            if victim is None:
                return
            self._demote(victim)

    def _demote(self, b: _Block) -> None:
        if b.arr is not None:
            if b.blob is None and not b.file_ok:
                raw = b.arr.tobytes()
                t0 = time.perf_counter()
                blob = formats.compress_blob(raw, WARM_MODE)
                self.stats.compress_seconds += time.perf_counter() - t0
                if len(blob) < b.raw_bytes:
                    b.blob = blob
                    self._mem += len(blob)
                else:
                    # incompressible: a warm blob would not shrink memory,
                    # so spill straight to the disk tier
                    self._spill(b, raw)
            self._mem -= b.arr.nbytes
            b.arr = None
        elif b.blob is not None:
            if not b.file_ok:
                t0 = time.perf_counter()
                raw = formats.decompress_blob(b.blob, WARM_MODE)
                self.stats.decompress_seconds += time.perf_counter() - t0
                self._spill(b, raw)
            self._mem -= len(b.blob)
            b.blob = None

    def _spill(self, b: _Block, raw: bytes) -> None:
        t0 = time.perf_counter()
        fb = formats.compress_blob(raw, COLD_MODE)
        self.stats.compress_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        path = self._path(b)
        if self.spill_dir:
            os.makedirs(self.spill_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(fb)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.stats.disk_seconds += time.perf_counter() - t0
        self.stats.spills += 1
        self.stats.spill_bytes += len(fb)
        b.file_ok = True
