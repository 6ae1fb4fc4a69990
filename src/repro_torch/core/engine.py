"""Out-of-core GAB engine on PyTorch — the paper's MPE (§III-C, Algorithm 5).

Emulates N servers x T workers in one process with *real* out-of-core
behaviour: tiles live in the TileStore (disk tier), each server owns a
round-robin tile subset and an EdgeCache over "idle" memory, vertex state
is fully replicated (All-in-All) on the host, and the per-superstep
Broadcast payloads are measured (and actually compressed) through
core.comm.  Each superstep copies the values to the device once; each
tile's edge arrays go host→device once and its Gather+Apply runs as one
kernel (``seg_impl="fused"``) or the program's gather and apply around
the segment kernel (``"segment"``).

This port covers the tiled, serial, in-process engine for single-query
programs.  Every other knob of :class:`EngineConfig` keeps its field, and
a non-default value raises ``NotImplementedError`` naming its ROADMAP.md
queue item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.bloom import BloomFilter, SourceBlockBitmap
from repro_torch.core.cache import EdgeCache, auto_select_mode
from repro_torch.core.gab import SEG_IMPLS, VertexProgram, run_tile
from repro_torch.core.partition import assign_tiles, assign_tiles_balanced
from repro_torch.core.tiles import tile_edge_values
from repro_torch.graphio.formats import TileStore


@dataclasses.dataclass
class EngineConfig:
    """All engine knobs, with the reference's names and defaults; the port
    adds ``device`` and names its kernels in ``seg_impl``.  Knobs outside
    the port's slice raise when set (see :meth:`unsupported`)."""
    num_servers: int = 1
    num_workers: int = 1                    # paper's T (accounting only here)
    cache_capacity_bytes: int = 1 << 30     # per server
    cache_mode: int | str = "auto"          # 1..4 or "auto"
    # "lru": paper-faithful whole-cache single mode + LRU eviction;
    # "tiered" / "cost-aware" are ROADMAP.md A.5
    cache_policy: str = "lru"
    cache_promote_hits: int = 2             # hits between tier promotions
    # cache-hit-first tile ordering (order never changes results)
    cache_aware_order: bool = True
    comm_mode: str = "hybrid"               # dense | sparse | hybrid
    comm_compressor: str = "zstd-1"         # paper default: snappy
    comm_threshold: float = comm.DENSITY_THRESHOLD
    tile_skipping: bool = True
    skip_filter: str = "bitmap"             # "bitmap" (exact) | "bloom" (paper)
    skip_density_threshold: float = 0.05    # paper: only when few updates
    # "fused": the fused gather→combine→apply kernel for programs with a
    # FusedSpec, the segment kernel otherwise; "segment": the program's
    # gather and apply around the segment kernel.  (The reference's "jnp"
    # XLA-scatter backend has no counterpart on the card.)
    seg_impl: str = "fused"
    kernel_autotune: bool = False           # ROADMAP.md A.5
    kernel_blocks: Optional[tuple] = None   # ROADMAP.md A.5
    max_supersteps: int = 200
    balanced_assignment: bool = False       # beyond-paper LPT stage-2
    bloom_bits: int = 1 << 16
    block_shift: int = 8
    engine_mode: str = "tiled"              # "stacked"/"merged": ROADMAP.md A.5
    device_budget_bytes: int = 1 << 30      # per server, for "stacked"
    # wire accounting: "full" compresses every payload (measured bytes);
    # "sampled" is ROADMAP.md A.5
    comm_accounting: str = "full"
    pipeline: bool = False                  # ROADMAP.md A.5
    prefetch_depth: int = 4
    prefetch_workers: int = 2
    stack_size: int = 4
    debug_skip_log: bool = False            # ROADMAP.md A.5
    vertex_memory_budget: Optional[int] = None   # ROADMAP.md A.6
    num_intervals: int = 0
    interval_aware_order: bool = True
    server_rank: Optional[int] = None       # ROADMAP.md A.9
    checkpoint_dir: Optional[str] = None    # ROADMAP.md A.10
    checkpoint_every: int = 0
    checkpoint_keep: int = 2
    resume: bool = False                    # ROADMAP.md A.10
    preemptible: bool = False               # ROADMAP.md A.10
    fault_plan: Optional[object] = None     # ROADMAP.md A.10
    admit_plan: Optional[tuple] = None      # ROADMAP.md A.7
    # where tiles compute: "cuda" launches the kernels, "cpu" runs their
    # plain PyTorch versions (the tests)
    device: str = "cuda"

    def unsupported(self) -> list[str]:
        """The knobs set outside the port's slice, each with the ROADMAP.md
        queue item that will bring it."""
        out = []
        checks = (
            (self.pipeline, "pipeline=True (pipelined engine)", "A.5"),
            (self.engine_mode != "tiled",
             f"engine_mode={self.engine_mode!r}", "A.5"),
            (self.kernel_autotune, "kernel_autotune=True", "A.5"),
            (self.kernel_blocks is not None, "kernel_blocks", "A.5"),
            (self.cache_policy != "lru",
             f"cache_policy={self.cache_policy!r} (tiered cache)", "A.5"),
            (self.comm_accounting != "full",
             f"comm_accounting={self.comm_accounting!r}", "A.5"),
            (self.debug_skip_log, "debug_skip_log=True", "A.5"),
            (self.vertex_memory_budget is not None,
             "vertex_memory_budget (out-of-core vertex state)", "A.6"),
            (self.admit_plan is not None, "admit_plan (admission)", "A.7"),
            (self.server_rank is not None,
             "server_rank (cluster runtime)", "A.9"),
            (self.checkpoint_dir is not None, "checkpoint_dir", "A.10"),
            (self.resume, "resume=True", "A.10"),
            (self.preemptible, "preemptible=True", "A.10"),
            (self.fault_plan is not None, "fault_plan", "A.10"),
        )
        for on, what, item in checks:
            if on:
                out.append(f"{what} is ROADMAP.md queue {item}")
        return out


@dataclasses.dataclass
class SuperstepStats:
    """Per-superstep measurements (bytes are real payload/compressed sizes,
    seconds wall-clock) — the reference's fields for single-query,
    in-memory runs."""
    superstep: int
    seconds: float
    load_seconds: float
    compute_seconds: float
    updated_vertices: int
    density: float
    tiles_processed: int
    tiles_skipped: int
    raw_bytes: int            # sum over servers of broadcast payload
    wire_bytes: int           # after compression
    network_bytes: int        # wire * (N-1): each server ships to N-1 peers
    cache_hit_ratio: float
    disk_bytes_read: int      # bytes read from the disk tier THIS superstep
    # time the compute loop spent blocked on tile data (serial: all of it)
    stall_seconds: float = 0.0
    # disk read + (de)compress busy time this superstep
    io_busy_seconds: float = 0.0
    # tiered-cache activity this superstep (zeros for policy="lru")
    cache_promotions: int = 0
    cache_demotions: int = 0
    # per-tier residency at the barrier: {tier: {tiles, bytes, hits}}
    cache_tiers: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunResult:
    """Final vertex values [V] + aux arrays + per-superstep history of one
    engine run."""
    values: np.ndarray
    aux: dict
    history: list[SuperstepStats]
    supersteps: int
    converged: bool

    def total_seconds(self) -> float:
        """Wall-clock sum over all supersteps."""
        return sum(h.seconds for h in self.history)

    def _steady_state(self, skip_first: bool) -> list[SuperstepStats]:
        """History minus the warm-up superstep, unless that would leave
        nothing to average."""
        hs = self.history[1:] if skip_first else self.history
        return hs if hs else self.history

    def mean_superstep_seconds(self, skip_first: bool = True) -> float:
        """Steady-state mean seconds per superstep (see ``_steady_state``)."""
        hs = self._steady_state(skip_first)
        return float(np.mean([h.seconds for h in hs])) if hs else 0.0

    def disk_stall_fraction(self, skip_first: bool = True) -> float:
        """Fraction of wall time the compute loop was blocked on tile I/O."""
        hs = self._steady_state(skip_first)
        tot = sum(h.seconds for h in hs)
        return sum(h.stall_seconds for h in hs) / tot if tot > 0 else 0.0


class OutOfCoreEngine:
    """The out-of-core superstep engine (see module docstring), emulating
    all ``cfg.num_servers`` servers in one process."""

    def __init__(self, store: TileStore, config: EngineConfig = EngineConfig()):
        problems = config.unsupported()
        if problems:
            raise NotImplementedError("; ".join(problems))
        if config.seg_impl not in SEG_IMPLS:
            raise ValueError(
                f"seg_impl {config.seg_impl!r}: the port has "
                f"{', '.join(SEG_IMPLS)} (the reference's 'jnp' XLA "
                f"scatter has no counterpart on the card)")
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {config.device!r} requested but "
                               "PyTorch sees no CUDA device")
        self.store = store
        self.cfg = config
        self.plan = store.load_plan()
        self.in_degree, self.out_degree = store.load_degrees()
        P, N = self.plan.num_tiles, config.num_servers
        if config.balanced_assignment:
            self.assignment = assign_tiles_balanced(self.plan.edges_per_tile, N)
        else:
            self.assignment = assign_tiles(P, N)
        self.exec_servers = list(range(N))

        # Per-server edge caches (paper: idle memory on each server).
        if config.cache_mode == "auto":
            # Working set per server ~ share of total on-disk tile bytes.
            total = sum(store.tile_disk_bytes(t) for t in range(P))
            mode = auto_select_mode(total // max(N, 1),
                                    config.cache_capacity_bytes)
        else:
            mode = int(config.cache_mode)
        self.cache_mode = mode
        self.caches = {
            s: EdgeCache(store, config.cache_capacity_bytes, mode,
                         policy=config.cache_policy,
                         promote_hits=config.cache_promote_hits)
            for s in self.exec_servers
        }
        self._filters: Optional[list] = None  # built during first superstep
        # Per-superstep deltas are computed against these cumulative-counter
        # baselines; each session re-baselines them when it opens.
        self._io_busy_cum = 0.0
        self._promo_cum = 0
        self._demo_cum = 0
        self._disk_cum = 0

    # ------------------------------------------------------------------
    def open_session(self, prog: VertexProgram, *,
                     max_supersteps: Optional[int] = None) -> "EngineSession":
        """Open a step-driven session over ``prog``: one ``session.step()``
        executes exactly one superstep."""
        return EngineSession(self, prog, max_supersteps=max_supersteps)

    def run(self, prog: VertexProgram,
            max_supersteps: Optional[int] = None) -> RunResult:
        """Run ``prog`` to convergence (no updated vertices) or
        ``max_supersteps``."""
        session = self.open_session(prog, max_supersteps=max_supersteps)
        while not session.finished:
            session.step()
        return session.result()

    # ------------------------------------------------------------------
    def _measure_broadcast(self, si, sv, nv, dtype):
        """Build one server's broadcast payload from its update list and
        measure its wire size (a BroadcastRecord)."""
        cfg = self.cfg
        upd_mask = np.zeros(nv, dtype=bool)
        upd_mask[si] = True
        values = np.zeros(nv, dtype=dtype)
        values[si] = sv
        return comm.plan_broadcast(values, upd_mask,
                                   threshold=cfg.comm_threshold,
                                   compressor=cfg.comm_compressor,
                                   mode=cfg.comm_mode)

    def _make_filter(self, tile, nv):
        srcs = tile.source_ids()
        if self.cfg.skip_filter == "bitmap":
            f = SourceBlockBitmap(nv, self.cfg.block_shift)
        else:
            f = BloomFilter(num_bits=self.cfg.bloom_bits)
        f.add(srcs)
        return f

    def _order_cache_first(self, s: int, tids: list[int]) -> list[int]:
        """Cache-hit-first scheduling: resident tiles run first.  Stable
        within each class; order never changes results (tiles own
        disjoint rows)."""
        cache = self.caches[s]
        resident = {t for t in tids if cache.contains(t)}
        if not resident or len(resident) == len(tids):
            return list(tids)
        return ([t for t in tids if t in resident]
                + [t for t in tids if t not in resident])

    def _agg_cache_stats(self) -> dict:
        """Aggregate hit/miss/tier/io counters over the edge caches."""
        caches = list(self.caches.values())
        hits = sum(c.stats.hits for c in caches)
        misses = sum(c.stats.misses for c in caches)
        tiers: dict[str, dict] = {}
        for c in caches:
            for name, d in c.tier_snapshot().items():
                agg = tiers.setdefault(name, dict(tiles=0, bytes=0, hits=0))
                agg["tiles"] += d.get("tiles", 0)
                agg["bytes"] += d.get("bytes", 0)
                agg["hits"] += d.get("hits", 0)
        return dict(
            hit_ratio=hits / max(hits + misses, 1),
            disk_bytes_read=sum(c.stats.disk_bytes_read for c in caches),
            io_seconds=sum(c.stats.disk_seconds + c.stats.decompress_seconds
                           + c.stats.retier_seconds for c in caches),
            promotions=sum(c.stats.promotions for c in caches),
            demotions=sum(c.stats.demotions for c in caches),
            tiers=tiers,
        )


class EngineSession:
    """Step-driven run state over one :class:`OutOfCoreEngine`: one
    ``step()`` call executes exactly one superstep (skip pre-pass, tile
    compute, BSP barrier, update apply); ``result()`` returns the
    :class:`RunResult` once the session is finished (converged or at
    ``max_supersteps``)."""

    def __init__(self, engine: OutOfCoreEngine, prog: VertexProgram, *,
                 max_supersteps: Optional[int] = None):
        self.eng = engine
        self.prog = prog
        cfg = engine.cfg
        nv = self.nv = engine.plan.num_vertices
        self.history: list[SuperstepStats] = []
        self.converged = False
        self.finished = False
        self._final_result: Optional[RunResult] = None
        self._ss = 0

        # Re-baseline the engine's cumulative-counter deltas, so cache
        # activity before this session does not leak into its first step.
        cs = engine._agg_cache_stats()
        engine._io_busy_cum = cs["io_seconds"]
        engine._promo_cum = cs["promotions"]
        engine._demo_cum = cs["demotions"]
        engine._disk_cum = cs["disk_bytes_read"]

        state = prog.init(nv, engine.out_degree.astype(np.float64),
                          engine.in_degree.astype(np.float64))
        self.values = np.asarray(state.pop("value"))
        if self.values.ndim != 1 or getattr(prog, "num_queries", 1) != 1:
            raise NotImplementedError(
                "batched [V, Q] programs are ROADMAP.md queue A.5")
        self.aux_np = {k: np.asarray(v) for k, v in state.items()}
        self.vdtype = self.values.dtype
        self.aux_dev = {k: torch.from_numpy(np.ascontiguousarray(v))
                        .to(engine.device) for k, v in self.aux_np.items()}

        self.max_ss = max_supersteps or cfg.max_supersteps
        self.updated_ids = np.arange(nv)  # everything "updated" pre step 0
        self.building_filters = cfg.tile_skipping
        self.filters: list = ([None] * engine.plan.num_tiles
                              if self.building_filters else [])

    def step(self) -> SuperstepStats:
        """Execute exactly one superstep (compute → barrier → apply) and
        return its stats."""
        if self.finished:
            raise RuntimeError("session is finished — open a new one")
        eng = self.eng
        cfg = eng.cfg
        prog = self.prog
        nv = self.nv
        vdtype = self.vdtype
        row_cap = eng.plan.row_cap
        filters = self.filters
        building_filters = self.building_filters
        ss = self._ss

        t_start = time.perf_counter()
        # the values go to the device once per superstep
        values_dev = torch.from_numpy(self.values).to(eng.device)
        load_s = 0.0
        comp_s = 0.0
        stall_s = 0.0
        tiles_done = 0
        tiles_skipped = 0
        per_server_updates: list[tuple] = []

        skip_on = (
            cfg.tile_skipping
            and ss > 0
            and len(self.updated_ids) < cfg.skip_density_threshold * nv
            and eng._filters is not None
        )
        active_words = None
        if skip_on and cfg.skip_filter == "bitmap":
            active_words = SourceBlockBitmap.active_words_from_ids(
                self.updated_ids, nv, cfg.block_shift
            )

        for s in eng.exec_servers:
            s_idx: list[np.ndarray] = []
            s_val: list[np.ndarray] = []
            server_tiles = eng.assignment[s]
            # Tile-skipping pre-pass: the filter set is fixed for the whole
            # superstep, so the survivor list is computed up front.
            if skip_on:
                run_list = []
                for tid in server_tiles:
                    f = eng._filters[tid]
                    hit = (f.intersects(active_words)
                           if cfg.skip_filter == "bitmap"
                           else f.might_contain_any(self.updated_ids))
                    if hit:
                        run_list.append(tid)
                    else:
                        tiles_skipped += 1
            else:
                run_list = list(server_tiles)
            if cfg.cache_aware_order and len(run_list) > 1:
                run_list = eng._order_cache_first(s, run_list)

            for tid in run_list:
                t0 = time.perf_counter()
                tile = eng.caches[s].get(tid)
                dt = time.perf_counter() - t0
                load_s += dt
                stall_s += dt   # serial: every load blocks compute

                if building_filters and filters[tid] is None:
                    filters[tid] = eng._make_filter(tile, nv)

                t0 = time.perf_counter()
                rows, new, upd = run_tile(
                    prog, values_dev, self.aux_dev,
                    (tile.src, tile.dst_local, tile_edge_values(tile)),
                    tile.meta.row_start, tile.meta.num_rows, row_cap,
                    cfg.seg_impl,
                )
                upd = upd.cpu().numpy()
                ri, rv = rows.cpu().numpy()[upd], new.cpu().numpy()[upd]
                comp_s += time.perf_counter() - t0
                s_idx.append(ri)
                s_val.append(rv)
                tiles_done += 1
            si = np.concatenate(s_idx) if s_idx else np.zeros(0, np.int64)
            sv = (np.concatenate(s_val) if s_val
                  else np.zeros((0,), vdtype))
            per_server_updates.append((si, sv))

        if building_filters and all(filters[t] is not None
                                    for t in range(eng.plan.num_tiles)):
            eng._filters = filters
            self.building_filters = False

        # --- Broadcast (BSP barrier): measure payloads, apply updates ---
        raw_b = wire_b = 0
        for si, sv in per_server_updates:
            rec = eng._measure_broadcast(si, sv, nv, vdtype)
            raw_b += rec.raw_bytes
            wire_b += rec.wire_bytes
        all_idx = np.concatenate([u[0] for u in per_server_updates])
        all_val = np.concatenate([u[1] for u in per_server_updates])
        self.values[all_idx] = all_val
        self.updated_ids = all_idx

        cache_stats = eng._agg_cache_stats()
        io_busy = cache_stats["io_seconds"] - eng._io_busy_cum
        eng._io_busy_cum = cache_stats["io_seconds"]
        promo = cache_stats["promotions"] - eng._promo_cum
        demo = cache_stats["demotions"] - eng._demo_cum
        eng._promo_cum = cache_stats["promotions"]
        eng._demo_cum = cache_stats["demotions"]
        disk_b = cache_stats["disk_bytes_read"] - eng._disk_cum
        eng._disk_cum = cache_stats["disk_bytes_read"]

        stats = SuperstepStats(
            superstep=ss,
            seconds=time.perf_counter() - t_start,
            load_seconds=load_s,
            compute_seconds=comp_s,
            updated_vertices=int(len(all_idx)),
            density=float(len(all_idx)) / max(nv, 1),
            tiles_processed=tiles_done,
            tiles_skipped=tiles_skipped,
            raw_bytes=raw_b,
            wire_bytes=wire_b,
            network_bytes=wire_b * max(cfg.num_servers - 1, 0),
            cache_hit_ratio=cache_stats["hit_ratio"],
            disk_bytes_read=disk_b,
            stall_seconds=stall_s,
            io_busy_seconds=io_busy,
            cache_promotions=promo,
            cache_demotions=demo,
            cache_tiers=cache_stats["tiers"],
        )
        self.history.append(stats)
        self.converged = len(all_idx) == 0
        self._ss = ss + 1
        self.finished = self.converged or self._ss >= self.max_ss
        return stats

    def result(self) -> RunResult:
        """The session's RunResult; the session must be finished."""
        if self._final_result is None:
            if not self.finished:
                raise RuntimeError("session still live — step() to "
                                   "completion first")
            self._final_result = RunResult(
                values=self.values, aux=self.aux_np, history=self.history,
                supersteps=len(self.history), converged=self.converged)
        return self._final_result
