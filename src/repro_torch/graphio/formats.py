"""Tile store — GraphH's "DFS" tier (paper §III-A).

Tiles are serialized to one binary blob each (header + raw little-endian
array bytes), optionally zstd-compressed, and written to a directory:

    store/
      meta.json            partition plan + graph metadata
      degrees.npz          in_degree / out_degree arrays (paper: SPE output)
      tiles/t<id>.bin      serialized tiles

The same serializer feeds the edge-cache tier (core/cache.py) so the cache
can hold compressed blobs at any of the paper's four modes.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

from repro_torch.compat import zstd_compress, zstd_decompress
from repro_torch.core.partition import IntervalPlan, PartitionPlan
from repro_torch.core.tiles import Tile, TileMeta

# Versioned tile format: GHT1 is the original layout; GHT2 appends the
# source-interval bucket-sort permutation (``Tile.iv_perm``, DESIGN.md §10)
# after the value array.  Readers accept both; writers emit GHT2 only when a
# footprint is attached, so stores built without an interval plan stay
# byte-identical to the v1 format.
MAGIC = b"GHT1"
MAGIC_V2 = b"GHT2"

# The paper's cache modes: 1=raw, 2=snappy, 3=zlib-1, 4=zlib-3.  snappy/zlib
# are not shipped in this environment; zstd levels are the stand-ins with the
# same fast/slow compression trade-off shape (DESIGN.md §3).  When zstandard
# itself is unavailable, repro.compat transparently substitutes stdlib zlib
# at the same levels.
MODE_CODECS = {
    1: ("raw", None),
    2: ("zstd-1", 1),     # snappy analogue: fast, modest ratio
    3: ("zstd-3", 3),     # zlib-1 analogue
    4: ("zstd-9", 9),     # zlib-3 analogue: slow, best ratio
}


def compress_blob(blob: bytes, mode: int) -> bytes:
    """Compress ``blob`` at one of the paper's four modes (1 = raw
    passthrough); see MODE_CODECS for the ladder."""
    name, level = MODE_CODECS[mode]
    if level is None:
        return blob
    return zstd_compress(blob, level)


def decompress_blob(blob: bytes, mode: int) -> bytes:
    """Inverse of ``compress_blob`` for the same mode."""
    name, level = MODE_CODECS[mode]
    if level is None:
        return blob
    return zstd_decompress(blob)


def serialize_tile(tile: Tile) -> bytes:
    """Tile -> one binary blob: magic + JSON header + raw little-endian
    arrays (GHT2 appends iv_perm when a footprint is attached)."""
    v2 = tile.iv_perm is not None
    header = dict(
        meta=tile.meta.to_dict(),
        weighted=tile.val is not None,
        row_ptr_len=int(tile.row_ptr.shape[0]),
    )
    if v2:
        header["iv_perm_len"] = int(tile.iv_perm.shape[0])
    hb = json.dumps(header).encode()
    out = io.BytesIO()
    out.write(MAGIC_V2 if v2 else MAGIC)
    out.write(struct.pack("<I", len(hb)))
    out.write(hb)
    out.write(tile.src.astype("<i4").tobytes())
    out.write(tile.dst_local.astype("<i4").tobytes())
    out.write(tile.row_ptr.astype("<i4").tobytes())
    if tile.val is not None:
        out.write(tile.val.astype("<f4").tobytes())
    if v2:
        out.write(tile.iv_perm.astype("<i4").tobytes())
    return out.getvalue()


def deserialize_tile(blob: bytes) -> Tile:
    """Inverse of ``serialize_tile`` (accepts GHT1 and GHT2)."""
    magic = blob[:4]
    assert magic in (MAGIC, MAGIC_V2), "bad tile magic"
    (hlen,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8 : 8 + hlen].decode())
    meta = TileMeta.from_dict(header["meta"])
    off = 8 + hlen
    ecap = meta.edge_cap

    def take(n, dtype):
        nonlocal off
        a = np.frombuffer(blob, dtype=dtype, count=n, offset=off).copy()
        off += n * np.dtype(dtype).itemsize
        return a

    src = take(ecap, "<i4")
    dst_local = take(ecap, "<i4")
    row_ptr = take(header["row_ptr_len"], "<i4")
    val = take(ecap, "<f4") if header["weighted"] else None
    iv_perm = (take(header["iv_perm_len"], "<i4")
               if magic == MAGIC_V2 else None)
    return Tile(meta=meta, src=src, dst_local=dst_local, val=val,
                row_ptr=row_ptr, iv_perm=iv_perm)


class TileStore:
    """Directory-backed tile store with optional at-rest compression."""

    #: lock discipline, enforced by tools/analyze.py --check locks
    _guarded_by = {"bytes_read": "_stats_lock",
                   "bytes_written": "_stats_lock"}

    def __init__(self, root: str, disk_mode: int = 1):
        self.root = root
        self.disk_mode = disk_mode
        self.tile_dir = os.path.join(root, "tiles")
        self.bytes_read = 0
        self.bytes_written = 0
        self._stats_lock = threading.Lock()  # prefetch workers share counters

    # -- write side (SPE) --------------------------------------------------
    def initialize(self, plan: PartitionPlan, weighted: bool,
                   in_degree: np.ndarray, out_degree: np.ndarray,
                   interval_plan: Optional[IntervalPlan] = None) -> None:
        """Write meta.json (partition plan + optional interval plan) and the
        degree arrays; creates the tiles/ directory."""
        os.makedirs(self.tile_dir, exist_ok=True)
        meta = dict(
            plan=plan.to_dict(),
            weighted=weighted,
            disk_mode=self.disk_mode,
        )
        if interval_plan is not None:
            meta["interval_plan"] = interval_plan.to_dict()
        tmp = os.path.join(self.root, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, "meta.json"))
        # stage through a file object: np.savez would append ".npz" to a
        # bare "degrees.npz.tmp" path and the publish would miss it
        dtmp = os.path.join(self.root, "degrees.npz.tmp")
        with open(dtmp, "wb") as f:
            np.savez(f, in_degree=in_degree, out_degree=out_degree)
            f.flush()
            os.fsync(f.fileno())
        os.replace(dtmp, os.path.join(self.root, "degrees.npz"))

    def write_tile(self, tile: Tile) -> int:
        """Serialize + disk-mode-compress + atomically write one tile; returns
        the on-disk byte count."""
        blob = compress_blob(serialize_tile(tile), self.disk_mode)
        path = self._tile_path(tile.meta.tile_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: a reader never sees a torn tile
        with self._stats_lock:
            self.bytes_written += len(blob)
        return len(blob)

    # -- read side (MPE) ---------------------------------------------------
    def load_meta(self) -> dict:
        """Read meta.json (also refreshes ``self.disk_mode``)."""
        with open(os.path.join(self.root, "meta.json")) as f:
            meta = json.load(f)
        self.disk_mode = meta["disk_mode"]
        return meta

    def load_plan(self) -> PartitionPlan:
        """The stage-1 PartitionPlan recorded at preprocessing time."""
        return PartitionPlan.from_dict(self.load_meta()["plan"])

    def fingerprint(self) -> str:
        """Stable identity of the preprocessed graph, used as a result-cache
        key component (serve.graph_service).  Hashes meta.json, the degree
        archive bytes, and the sorted (name, size) tile listing — cheap (tile
        payloads are not read) and **conservative**: two different graphs
        never collide (their degree bytes differ), while a byte-level rebuild
        of the same graph may re-key the cache (npz zip timestamps) — a
        spurious miss, never a wrong hit."""
        h = hashlib.sha256()
        with open(os.path.join(self.root, "meta.json"), "rb") as f:
            h.update(f.read())
        deg = os.path.join(self.root, "degrees.npz")
        if os.path.exists(deg):
            with open(deg, "rb") as f:
                h.update(f.read())
        if os.path.isdir(self.tile_dir):
            for name in sorted(os.listdir(self.tile_dir)):
                size = os.stat(os.path.join(self.tile_dir, name)).st_size
                h.update(f"{name}:{size};".encode())
        return h.hexdigest()[:16]

    def load_interval_plan(self) -> Optional[IntervalPlan]:
        """Interval plan recorded at preprocessing time (DESIGN.md §10), or
        None for stores built without one — the engine then derives a plan
        from the tile splitter and computes footprints lazily."""
        d = self.load_meta().get("interval_plan")
        return IntervalPlan.from_dict(d) if d is not None else None

    def load_degrees(self) -> tuple[np.ndarray, np.ndarray]:
        """(in_degree [V], out_degree [V]) int64 arrays from degrees.npz."""
        z = np.load(os.path.join(self.root, "degrees.npz"))
        return z["in_degree"], z["out_degree"]

    def read_tile_blob(self, tile_id: int) -> bytes:
        """Raw (possibly disk-compressed) blob — what the cache stores."""
        with open(self._tile_path(tile_id), "rb") as f:
            blob = f.read()
        with self._stats_lock:
            self.bytes_read += len(blob)
        return blob

    def read_tile(self, tile_id: int) -> Tile:
        """Read + decompress + deserialize one tile from disk."""
        return deserialize_tile(
            decompress_blob(self.read_tile_blob(tile_id), self.disk_mode)
        )

    def tile_disk_bytes(self, tile_id: int) -> int:
        """On-disk (post disk-mode compression) size of one tile, in bytes."""
        return os.path.getsize(self._tile_path(tile_id))

    def iter_tiles(self, tile_ids: Iterator[int]) -> Iterator[Tile]:
        """Yield tiles in the given id order (serial reads; see
        ``prefetch_iter`` for the overlapped path)."""
        for t in tile_ids:
            yield self.read_tile(t)

    def prefetch_iter(self, tile_ids: Iterable[int], depth: int = 4,
                      cache=None, workers: int = 2) -> Iterator[tuple[int, Tile]]:
        """Yield ``(tile_id, Tile)`` in order, reading + decompressing up to
        ``depth`` tiles ahead on ``workers`` background threads (the
        pipelined engine's I/O stage — paper §IV: keep the disk busy while
        workers compute).  Multiple workers matter because decompression is
        the dominant per-tile cost and zlib/zstd release the GIL.

        When an :class:`~repro.core.cache.EdgeCache` is passed, lookups go
        through it on the prefetch threads: the cache is consulted
        (``get_if_resident``) before any disk read is issued, so hits decode
        straight from idle memory without touching the disk; misses are read
        once and admitted to the cache, and hit/miss/disk stats accrue
        exactly as on the serial path.  EdgeCache does its codec work
        outside its lock, so workers genuinely overlap.  The engine feeds
        this iterator a cache-hit-first tile order (``cache_aware_order``),
        so resident tiles flow to the consumer immediately while the
        workers' lookahead pulls the misses off disk behind them.

        ``depth`` bounds memory: at most ``depth`` tiles are decoded-but-
        unconsumed (completed or in flight) at any moment, regardless of
        worker count.  Delivery order always matches ``tile_ids`` order.

        In-flight reads are deduplicated: when two workers want the same
        tile id concurrently (duplicate ids in ``tile_ids``), the second
        waits for the first's read to land in the cache instead of issuing
        a second disk read for the same bytes.
        """
        ids = list(tile_ids)
        if not ids:
            return
        depth = max(1, depth)
        nworkers = max(1, min(workers, depth, len(ids)))
        budget = threading.Semaphore(depth)
        cond = threading.Condition()
        results: dict[int, tuple[int, Optional[Tile], Optional[BaseException]]] = {}
        cursor = [0]          # next id index to claim (under cond)
        stop = threading.Event()
        # tile id -> (event, [tile, exc]) for reads currently in flight: the
        # leader loads and publishes; followers wait on the event and reuse
        # the leader's result (which also sits in the cache by then) rather
        # than reading the same tile from disk a second time
        inflight: dict[int, tuple[threading.Event, list]] = {}
        iflock = threading.Lock()

        def _load(tid: int) -> Tile:
            # cache.get consults residency (get_if_resident) before
            # issuing any disk read: resident tiles decode straight
            # from idle memory, only misses touch the disk tier
            return cache.get(tid) if cache is not None else self.read_tile(tid)

        def produce() -> None:
            while not stop.is_set():
                if not budget.acquire(timeout=0.1):
                    continue  # re-check stop
                with cond:
                    i = cursor[0]
                    if i >= len(ids):
                        budget.release()
                        return
                    cursor[0] += 1
                tid = ids[i]
                with iflock:
                    entry = inflight.get(tid)
                    leader = entry is None
                    if leader:
                        entry = (threading.Event(), [None, None])
                        inflight[tid] = entry
                ev, slot = entry
                if leader:
                    try:
                        slot[0] = _load(tid)
                    except BaseException as exc:  # surfaced on the consumer
                        slot[1] = exc
                    finally:
                        with iflock:
                            inflight.pop(tid, None)
                        ev.set()
                else:
                    while not ev.wait(timeout=0.1):
                        if stop.is_set():
                            budget.release()
                            return
                    if slot[1] is not None:
                        # leader failed; retry independently so a transient
                        # error doesn't poison every duplicate
                        try:
                            slot = [_load(tid), None]
                        except BaseException as exc:
                            slot = [None, exc]
                item = (tid, slot[0], slot[1])
                with cond:
                    results[i] = item
                    cond.notify_all()

        threads = [threading.Thread(target=produce, daemon=True,
                                    name=f"graphh-prefetch-{w}")
                   for w in range(nworkers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(ids)):
                with cond:
                    while i not in results:
                        if not any(t.is_alive() for t in threads):
                            raise RuntimeError(
                                f"prefetch workers died before tile index {i}")
                        cond.wait(timeout=0.1)
                    tid, tile, exc = results.pop(i)
                budget.release()
                if exc is not None:
                    raise exc
                yield tid, tile
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)

    def _tile_path(self, tile_id: int) -> str:
        return os.path.join(self.tile_dir, f"t{tile_id:06d}.bin")
