"""Adaptive multi-tier edge cache (paper §III-D-2).

A cache over serialized tiles sitting in "idle" host memory.  Four codec
modes trade decompression CPU for capacity, exactly as the paper's
snappy/zlib ladder (we use zstd levels, see formats.MODE_CODECS):

  mode 1: raw blobs         (gamma_1 = 1)
  mode 2: zstd-1            (gamma_2 ~ 2,  snappy analogue)
  mode 3: zstd-3            (gamma_3 ~ 4,  zlib-1 analogue)
  mode 4: zstd-9            (gamma_4 ~ 5,  zlib-3 analogue)

Two ways to use the ladder:

* ``policy="lru"`` — the paper's whole-cache single mode, chosen once at
  startup (``auto_select_mode`` implements §III-D-2's rule: smallest i
  such that working_set / gamma_i <= capacity, else mode 3).  Plain LRU
  eviction.
* ``policy="tiered"`` / ``policy="cost-aware"`` — per-tile compression
  (GraphMP-style selective caching): tiles are admitted warm (zstd-1),
  promoted toward raw on repeated hits, and *demoted* (recompressed
  smaller) instead of evicted when capacity is tight; eviction only ever
  takes tiles already in the coldest tier.  ``cost-aware`` picks pressure
  victims by least decompress-seconds-saved per resident byte instead of
  recency.  ``maintain()`` re-tiers in the background of the superstep
  (the engine calls it at the BSP barrier; ``start_background()`` runs it
  on a timer thread instead).

      tier   mode  codec    role
      hot     1    raw      repeated hits, zero decode cost
      warm    2    zstd-1   admission tier
      cold    4    zstd-9   demotion target; the only evictable tier
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Iterable, Optional

from repro_torch.core.tiles import Tile
from repro_torch.graphio import formats
from repro_torch.graphio.formats import TileStore

# Paper §III-D-2: gamma_0..3 = 1, 2, 4, 5 (we index modes from 1).
DEFAULT_GAMMAS = {1: 1.0, 2: 2.0, 3: 4.0, 4: 5.0}

# hot -> warm -> cold compression modes for the tiered policies.
TIER_LADDER = (1, 2, 4)
TIER_NAMES = {1: "hot", 2: "warm", 4: "cold"}

POLICIES = ("lru", "tiered", "cost-aware")


def tier_name(mode: int) -> str:
    """Human-readable tier label for a compression mode (1/2/4 -> hot/warm/cold)."""
    return TIER_NAMES.get(mode, f"mode{mode}")


def auto_select_mode(
    working_set_bytes: int,
    capacity_bytes: int,
    gammas: dict[int, float] = DEFAULT_GAMMAS,
) -> int:
    """min i s.t. working_set / gamma_i <= capacity, else mode 3."""
    for mode in sorted(gammas):
        if working_set_bytes / gammas[mode] <= capacity_bytes:
            return mode
    return 3


class CacheStats:
    """Cumulative cache counters (seconds are wall-clock busy time; bytes
    are compressed blob sizes).  The engine reports per-superstep deltas."""
    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.promotions = 0
        self.demotions = 0
        self.tier_hits: dict[str, int] = {}
        self.disk_bytes_read = 0
        self.decompress_seconds = 0.0
        self.retier_seconds = 0.0     # promote/demote codec time (off hot path)
        self.disk_seconds = 0.0

    @property
    def hit_ratio(self) -> float:
        """hits / (hits + misses); 0.0 before any lookup."""
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def as_dict(self) -> dict:
        """Plain-dict snapshot (for logs/benchmark JSON)."""
        return dict(
            hits=self.hits, misses=self.misses, evictions=self.evictions,
            promotions=self.promotions, demotions=self.demotions,
            tier_hits=dict(self.tier_hits),
            hit_ratio=self.hit_ratio, disk_bytes_read=self.disk_bytes_read,
            decompress_seconds=self.decompress_seconds,
            retier_seconds=self.retier_seconds,
            disk_seconds=self.disk_seconds,
        )


@dataclasses.dataclass
class CacheEntry:
    """One resident tile: its compressed blob plus the heat bookkeeping
    that drives promotion/demotion decisions."""

    blob: bytes
    mode: int                 # current compression mode (TIER_LADDER member
    #                           for tiered policies, the fixed mode for lru)
    last_access: int = 0      # logical clock, not wall time
    hits: int = 0
    hits_since_retier: int = 0
    miss_cost_s: float = 0.0  # measured disk+decode seconds a miss would pay

    def value_density(self) -> float:
        """Decompress-seconds a miss would cost, amortized per resident byte
        and weighted by observed reuse — the cost-aware eviction score."""
        return self.miss_cost_s * (1 + self.hits) / max(len(self.blob), 1)


class EdgeCache:
    """Tile cache.  ``get`` returns a deserialized Tile; blobs are held
    compressed per entry (see module docstring for the tier ladder).
    A miss reads from the TileStore (disk tier).

    Thread-safe: the pipelined engine's prefetch workers
    (``TileStore.prefetch_iter``) perform lookups concurrently, so
    bookkeeping and stats are guarded by a lock — but disk reads and
    compress/decompress (the expensive part; both release the GIL) run
    *outside* it, so concurrent ``get`` calls genuinely overlap.  Two
    threads missing on the same tile may both read it from disk; the
    second insert replaces the first (byte-identical) blob.  Re-tier
    swaps verify blob identity before committing, so a concurrent
    replace simply wins over a stale promotion/demotion.
    """

    PROMOTE_WATERMARK = 0.70  # maintain(): promote only below this pressure
    DEMOTE_WATERMARK = 0.95   # maintain(): pre-demote LRU hot above this

    #: lock discipline, enforced by tools/analyze.py --check locks
    _guarded_by = {"_entries": "_lock", "_bytes": "_lock",
                   "_clock": "_lock", "stats": "_lock"}

    def __init__(self, store: TileStore, capacity_bytes: int, mode: int = 1,
                 policy: str = "lru", promote_hits: int = 2):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown cache policy {policy!r}; valid: {', '.join(POLICIES)}")
        self.store = store
        self.capacity_bytes = int(capacity_bytes)
        self.mode = mode
        self.policy = policy
        self.promote_hits = max(1, int(promote_hits))
        self._entries: OrderedDict[int, CacheEntry] = OrderedDict()
        self._bytes = 0
        self._clock = 0
        self._lock = threading.RLock()
        self._bg_stop: Optional[threading.Event] = None
        self._bg_thread: Optional[threading.Thread] = None
        self.stats = CacheStats()

    # -- public -------------------------------------------------------------
    @property
    def tiered(self) -> bool:
        """True for the per-tile hot/warm/cold policies ("tiered"/"cost-aware")."""
        return self.policy != "lru"

    def admission_mode(self) -> int:
        """Mode newly admitted tiles are compressed at: the warm tier for
        tiered policies, the fixed whole-cache mode for lru."""
        return TIER_LADDER[1] if self.tiered else self.mode

    def get(self, tile_id: int) -> Tile:
        """Return the deserialized Tile, reading + admitting from the TileStore
        on a miss.  Thread-safe; codec work runs outside the lock."""
        tile = self.get_if_resident(tile_id)
        if tile is not None:
            return tile
        blob, raw, miss_cost = self._read_and_pack(tile_id)
        self._admit(tile_id, blob, self.admission_mode(), miss_cost)
        return formats.deserialize_tile(raw)

    def get_if_resident(self, tile_id: int) -> Optional[Tile]:
        """Decode a resident tile, or return None without touching the disk
        (the prefetcher's consult-cache-before-reading entry point).  Counts
        a hit when resident and nothing otherwise — the subsequent ``get``
        counts the miss."""
        with self._lock:
            e = self._entries.get(tile_id)
            if e is None:
                return None
            self._entries.move_to_end(tile_id)
            self._clock += 1
            e.last_access = self._clock
            e.hits += 1
            e.hits_since_retier += 1
            self.stats.hits += 1
            name = tier_name(e.mode)
            self.stats.tier_hits[name] = self.stats.tier_hits.get(name, 0) + 1
            blob, mode = e.blob, e.mode
            # inline promotion only under low pressure; under pressure the
            # hit credit accumulates and maintain()/resize() promotes once
            # pressure drops (demote-don't-evict keeps the tile resident)
            want_promote = (
                self.tiered and mode != TIER_LADDER[0]
                and e.hits_since_retier >= self.promote_hits
                and self._bytes < self.PROMOTE_WATERMARK * self.capacity_bytes)
        t0 = time.perf_counter()
        raw = formats.decompress_blob(blob, mode)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats.decompress_seconds += dt
        if want_promote:
            self._try_promote(tile_id, blob, mode, raw)
        return formats.deserialize_tile(raw)

    def resident_bytes(self) -> int:
        """Current resident compressed bytes (<= capacity_bytes)."""
        with self._lock:
            return self._bytes

    def contains(self, tile_id: int) -> bool:
        """Residency test without touching stats or LRU order."""
        with self._lock:
            return tile_id in self._entries

    def clear(self) -> None:
        """Drop every entry (stats are kept; counters are cumulative)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def warm(self, tile_ids: Iterable[int]) -> int:
        """Pre-load tiles until the next one would no longer fit — warming a
        working set larger than capacity must not thrash out what was just
        admitted.  Returns how many of the requested tiles are resident when
        warming stops (already-resident tiles count, and count as hits)."""
        admitted = 0
        for tid in tile_ids:
            with self._lock:
                e = self._entries.get(tid)
                if e is not None:
                    self._entries.move_to_end(tid)
                    self._clock += 1
                    e.last_access = self._clock
                    self.stats.hits += 1
                    name = tier_name(e.mode)
                    self.stats.tier_hits[name] = \
                        self.stats.tier_hits.get(name, 0) + 1
                    admitted += 1
                    continue
            blob, _raw, miss_cost = self._read_and_pack(tid)
            with self._lock:
                if self._bytes + len(blob) > self.capacity_bytes:
                    return admitted      # full: stop, never evict while warming
                self._insert_locked(tid, blob, self.admission_mode(), miss_cost)
            admitted += 1
        return admitted

    def tier_snapshot(self) -> dict:
        """Resident tiles/bytes per tier plus cumulative hits per tier."""
        with self._lock:
            out: dict[str, dict] = {}
            for e in self._entries.values():
                d = out.setdefault(tier_name(e.mode), dict(tiles=0, bytes=0))
                d["tiles"] += 1
                d["bytes"] += len(e.blob)
            for name, h in self.stats.tier_hits.items():
                out.setdefault(name, dict(tiles=0, bytes=0))["hits"] = h
            return out

    def resize(self, capacity_bytes: int) -> dict:
        """Adjust the idle-memory budget at runtime — the "memory pressure
        changed" entry point.  Shrinking walks the policy's pressure ladder
        (demote before evict) down to the new budget; growing lets the
        follow-up ``maintain`` promote tiles whose hit credit accumulated
        while capacity was tight."""
        with self._lock:
            self.capacity_bytes = int(capacity_bytes)
        self._make_room(0)
        return self.maintain()

    def maintain(self, max_ops: int = 8) -> dict:
        """Background re-tiering: run off the tile hot path (the engine calls
        this at the superstep barrier).  Under low memory pressure, promote
        the hottest entries with pending hit credit; under very high
        pressure, pre-demote LRU non-cold entries so the next admissions
        don't pay the demotion cascade inline.  Bounded by ``max_ops``
        recompressions per call."""
        if not self.tiered or self.capacity_bytes <= 0:
            return dict(promoted=0, demoted=0)
        promoted = demoted = 0
        hot, cold = TIER_LADDER[0], TIER_LADDER[-1]
        for _ in range(max_ops):
            with self._lock:
                pressure = self._bytes / self.capacity_bytes
                action = None
                if pressure < self.PROMOTE_WATERMARK:
                    for tid in reversed(self._entries):       # MRU first
                        e = self._entries[tid]
                        if (e.mode != hot
                                and e.hits_since_retier >= self.promote_hits):
                            action = ("promote", tid, e.blob, e.mode)
                            break
                elif pressure > self.DEMOTE_WATERMARK:
                    for tid, e in self._entries.items():      # LRU first
                        # zero-reuse entries are cheaper to just evict at
                        # admission time — don't spend codec on them here
                        if e.mode != cold and e.hits > 0:
                            action = ("demote", tid, e.blob, e.mode)
                            break
            if action is None:
                break
            kind, tid, blob, mode = action
            if kind == "promote":
                t0 = time.perf_counter()
                raw = formats.decompress_blob(blob, mode)
                dt = time.perf_counter() - t0   # _try_promote times its own
                with self._lock:                # compress pass
                    self.stats.retier_seconds += dt
                if not self._try_promote(tid, blob, mode, raw):
                    break                 # promotion no longer fits: stop
                promoted += 1
            else:
                # _demote may abort (concurrent swap) or evict instead
                # (blob didn't shrink) — count only committed demotions
                if self._demote(tid, blob, mode):
                    demoted += 1
        return dict(promoted=promoted, demoted=demoted)

    def start_background(self, interval_s: float = 1.0) -> None:
        """Run ``maintain`` on a daemon timer thread (for long-running hosts;
        the engine prefers the deterministic barrier call)."""
        if self._bg_thread is not None:
            return
        self._bg_stop = threading.Event()
        stop = self._bg_stop

        def loop() -> None:
            while not stop.wait(interval_s):
                self.maintain()

        self._bg_thread = threading.Thread(target=loop, daemon=True,
                                           name="graphh-cache-retier")
        self._bg_thread.start()

    def stop_background(self) -> None:
        """Stop the background re-tier thread started by ``start_background``."""
        if self._bg_thread is None:
            return
        self._bg_stop.set()
        self._bg_thread.join(timeout=5.0)
        self._bg_thread = None
        self._bg_stop = None

    @staticmethod
    def auto(store: TileStore, capacity_bytes: int, working_set_bytes: int,
             gammas: dict[int, float] = DEFAULT_GAMMAS,
             policy: str = "lru") -> "EdgeCache":
        """Construct with the paper's auto-selected whole-cache mode for the
        given working set (see ``auto_select_mode``)."""
        mode = auto_select_mode(working_set_bytes, capacity_bytes, gammas)
        return EdgeCache(store, capacity_bytes, mode, policy=policy)

    # -- internals ----------------------------------------------------------
    def _read_and_pack(self, tile_id: int) -> tuple[bytes, bytes, float]:
        """Disk read + recompress at the admission mode; returns
        (cache_blob, raw_bytes, measured miss cost).  Stats are updated here
        so every load counts as exactly one miss."""
        t0 = time.perf_counter()
        disk_blob = self.store.read_tile_blob(tile_id)
        disk_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = formats.decompress_blob(disk_blob, self.store.disk_mode)
        cache_blob = formats.compress_blob(raw, self.admission_mode())
        codec_s = time.perf_counter() - t0
        with self._lock:
            self.stats.misses += 1
            self.stats.disk_seconds += disk_s
            self.stats.decompress_seconds += codec_s
            self.stats.disk_bytes_read += len(disk_blob)
        return cache_blob, raw, disk_s + codec_s

    def _insert_locked(self, tile_id: int, blob: bytes, mode: int,
                       miss_cost: float) -> None:
        old = self._entries.pop(tile_id, None)   # concurrent double-miss
        if old is not None:
            self._bytes -= len(old.blob)
        self._clock += 1
        self._entries[tile_id] = CacheEntry(
            blob=blob, mode=mode, last_access=self._clock,
            miss_cost_s=miss_cost)
        self._bytes += len(blob)

    def _admit(self, tile_id: int, blob: bytes, mode: int,
               miss_cost: float) -> bool:
        if len(blob) > self.capacity_bytes:
            return False  # single tile larger than the whole cache
        for _ in range(8):  # bounded retry under concurrent churn
            if not self._make_room(len(blob), exclude=tile_id):
                return False
            with self._lock:
                old = self._entries.pop(tile_id, None)
                if old is not None:
                    self._bytes -= len(old.blob)
                if self._bytes + len(blob) > self.capacity_bytes:
                    if old is not None:  # another thread filled the room
                        self._entries[tile_id] = old
                        self._bytes += len(old.blob)
                    continue
                if old is not None:      # keep the hotter entry's heat
                    self._entries[tile_id] = old
                    self._bytes += len(old.blob)
                    return True
                self._insert_locked(tile_id, blob, mode, miss_cost)
                return True
        return False

    def _make_room(self, incoming: int, exclude: Optional[int] = None) -> bool:
        """Free space for ``incoming`` bytes by the policy's pressure ladder:
        demote non-cold entries (recompress smaller) before evicting, evict
        only from the coldest tier.  Codec work runs outside the lock."""
        demotions = 0
        while True:
            with self._lock:
                if self._bytes + incoming <= self.capacity_bytes:
                    return True
                # cap demotion churn per admission: after that, evict-only
                evict_only = demotions > 2 * len(TIER_LADDER)
                act = self._victim(exclude, evict_only=evict_only)
                if act is None:
                    return False
                kind, tid = act
                if kind == "evict":
                    self._evict_locked(tid)
                    continue
                e = self._entries[tid]
                blob, mode = e.blob, e.mode
            demotions += 1
            self._demote(tid, blob, mode)

    def _victim(self, exclude: Optional[int],
                evict_only: bool = False) -> Optional[tuple[str, int]]:
        """Pick the pressure victim (caller holds the lock): ("demote", id)
        or ("evict", id), or None when nothing can be freed."""
        cand = [(tid, e) for tid, e in self._entries.items() if tid != exclude]
        if not cand:
            return None
        if self.policy == "lru":
            return ("evict", cand[0][0])
        cold = TIER_LADDER[-1]
        # Selective caching (GraphMP): only tiles with demonstrated reuse
        # earn the demote-instead-of-evict treatment.  A never-hit entry is
        # coldest in the reuse sense — evicting it directly keeps a
        # streaming scan from paying a recompress per admitted tile.
        if self.policy == "cost-aware":
            tid, e = min(cand,
                         key=lambda kv: (kv[1].value_density(),
                                         kv[1].last_access))
            if (evict_only or e.hits == 0 or e.mode == cold
                    or e.mode not in TIER_LADDER):
                return ("evict", tid)
            return ("demote", tid)
        # tiered: evict the LRU zero-reuse entry if any; otherwise demote
        # the LRU reused non-cold entry; evict cold only as the last rung.
        for tid, e in cand:
            if e.hits == 0:
                return ("evict", tid)
        if not evict_only:
            for tid, e in cand:
                if e.mode in TIER_LADDER[:-1]:
                    return ("demote", tid)
        for tid, e in cand:
            if e.mode == cold or e.mode not in TIER_LADDER:
                return ("evict", tid)
        return ("evict", cand[0][0])   # evict_only with no cold entries

    def _evict_locked(self, tile_id: int) -> None:
        e = self._entries.pop(tile_id, None)
        if e is not None:
            self._bytes -= len(e.blob)
            self.stats.evictions += 1

    def _demote(self, tile_id: int, old_blob: bytes, old_mode: int) -> bool:
        """Recompress one tier colder (outside the lock); commit only if the
        entry is unchanged and the blob actually shrank — tiles that don't
        compress are treated as already-coldest and evicted.  True only
        when a demotion committed (aborts/evictions return False), so
        callers never re-read ``stats`` to learn the outcome."""
        if old_mode not in TIER_LADDER or old_mode == TIER_LADDER[-1]:
            with self._lock:
                e = self._entries.get(tile_id)
                if e is not None and e.blob is old_blob:
                    self._evict_locked(tile_id)
            return False
        target = TIER_LADDER[TIER_LADDER.index(old_mode) + 1]
        t0 = time.perf_counter()
        new_blob = formats.compress_blob(
            formats.decompress_blob(old_blob, old_mode), target)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats.retier_seconds += dt
            e = self._entries.get(tile_id)
            if e is None or e.blob is not old_blob:
                return False
            if len(new_blob) >= len(old_blob):
                self._evict_locked(tile_id)
                return False
            self._bytes += len(new_blob) - len(old_blob)
            e.blob, e.mode = new_blob, target
            e.hits_since_retier = 0
            self.stats.demotions += 1
            return True

    def _try_promote(self, tile_id: int, old_blob: bytes, old_mode: int,
                     raw: bytes) -> bool:
        """Recompress one tier hotter (outside the lock).  Promotion grows
        the blob, so it only commits if it fits without evicting anything —
        under tight capacity the cache stays demoted instead.  True only
        when the promotion committed."""
        if old_mode not in TIER_LADDER or old_mode == TIER_LADDER[0]:
            return False
        target = TIER_LADDER[TIER_LADDER.index(old_mode) - 1]
        t0 = time.perf_counter()
        new_blob = formats.compress_blob(raw, target)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats.retier_seconds += dt
            e = self._entries.get(tile_id)
            if e is None or e.blob is not old_blob:
                return False
            delta = len(new_blob) - len(e.blob)
            if self._bytes + delta > self.capacity_bytes:
                e.hits_since_retier = 0   # capacity tight: stay put
                return False
            self._bytes += delta
            e.blob, e.mode = new_blob, target
            e.hits_since_retier = 0
            self.stats.promotions += 1
            return True
