"""Out-of-core GAB engine on PyTorch — the paper's MPE (§III-C, Algorithm 5).

Emulates N servers x T workers in one process with *real* out-of-core
behaviour: tiles live in the TileStore (disk tier), each server owns a
round-robin tile subset and an EdgeCache over "idle" memory, vertex state
is fully replicated (All-in-All) on the host, and the per-superstep
Broadcast payloads are measured (and actually compressed) through
core.comm.  Each superstep copies the values to the device once.  With
``EngineConfig.server_rank`` and a ``distributed.ClusterExchange`` the
engine is instead one real server of an N-process cluster
(``launch/cluster.py``): it runs its own tile share and merges the peers'
updates at the barrier through the exchange, bit-identical to the
emulation.

Three engine modes compute a server's tiles, with identical results:

* ``"tiled"`` — one tile at a time: its edge arrays go host→device once
  and its Gather+Apply runs as one kernel (``seg_impl="fused"``) or the
  program's gather and apply around the segment kernel (``"segment"``);
* ``"stacked"`` — up to ``device_budget_bytes`` of a server's tiles stay on
  the device and run as one stack per superstep (the rest stream tiled);
* ``"merged"`` — a server's tiles merge into one device-resident edge list
  reduced by the segment kernel straight into ``[V + 1]`` rows.

``pipeline=True`` reads and decodes tiles ahead on worker threads
(``TileStore.prefetch_iter``) while the main thread runs stacks of
``stack_size`` of them, and compresses each server's payload on the comm
executor while the next server computes.  Vertex values are ``[V]`` or,
for batched programs, ``[V, Q]``; a query column with no updates in a
superstep retires and is compacted out of the live state.

With ``vertex_memory_budget`` the vertex arrays leave memory too: they
are cut into source intervals held by a
:class:`~repro_torch.core.vstate.VertexStateStore` whose blocks spill to
disk beyond the budget; each tile's source values are gathered on the
host interval by interval and copied to the device with the tile
(``gab.run_tile_sharded``), and only the dirty intervals are written back
at the barrier.  Results are bit-identical to the in-memory run.

A session (:meth:`OutOfCoreEngine.open_session`) runs one superstep a
``step()``; between barriers a batched session admits fresh queries into
``[V, Q]`` columns freed by retirement and drains live ones
(:class:`EngineSession`), and ``EngineConfig.admit_plan`` scripts such
admissions for a whole run.

The knobs of later queue items keep their :class:`EngineConfig` field,
and a non-default value raises ``NotImplementedError`` naming its
ROADMAP.md queue item.
"""
from __future__ import annotations

import dataclasses
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.bloom import BloomFilter, SourceBlockBitmap
from repro_torch.core.cache import EdgeCache, auto_select_mode
from repro_torch.core.distributed import pad_stack_to
from repro_torch.core.gab import (SEG_IMPLS, VertexProgram,
                                  merged_server_step, run_tile,
                                  run_tile_sharded, run_tile_stack,
                                  stack_to_device, stacked_tiles_step)
from repro_torch.core.partition import (assign_tiles, assign_tiles_balanced,
                                        plan_intervals)
from repro_torch.core.tiles import (compute_source_footprint, stack_tiles,
                                    tile_edge_values)
from repro_torch.core.vstate import VertexStateStore
from repro_torch.graphio.formats import TileStore

ENGINE_MODES = ("tiled", "stacked", "merged")


@dataclasses.dataclass
class EngineConfig:
    """All engine knobs, with the reference's names and defaults; the port
    adds ``device`` and names its kernels in ``seg_impl``.  Knobs of later
    queue items raise when set (see :meth:`unsupported`)."""
    num_servers: int = 1
    num_workers: int = 1                    # paper's T (accounting only here)
    cache_capacity_bytes: int = 1 << 30     # per server
    cache_mode: int | str = "auto"          # 1..4 or "auto" (lru policy)
    # "lru": paper-faithful whole-cache single mode + LRU eviction;
    # "tiered": per-tile hot/warm/cold ladder, demote-before-evict;
    # "cost-aware": tiered with decompress-seconds-saved/byte victims
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
    # the reference's Pallas (BE, BR) block choice from a TPU roofline:
    # no kernel here takes blocks (ROADMAP.md A.12, roofline/kernel_tune.py)
    kernel_autotune: bool = False
    kernel_blocks: Optional[tuple] = None
    max_supersteps: int = 200
    balanced_assignment: bool = False       # beyond-paper LPT stage-2
    bloom_bits: int = 1 << 16
    block_shift: int = 8
    # "tiled" | "stacked" | "merged" (module docstring); stacked and merged
    # run tiled in supersteps where tile skipping is on
    engine_mode: str = "tiled"
    device_budget_bytes: int = 1 << 30      # per server, for "stacked"
    # wire accounting: "full" compresses every payload (measured bytes);
    # "sampled" compresses every 4th superstep and reuses the last ratio
    comm_accounting: str = "full"
    # pipelined superstep: tile reads ahead of compute, payload compression
    # behind it; pipeline=False keeps the paper-faithful serial loop
    pipeline: bool = False
    prefetch_depth: int = 4                 # tiles read+decompressed ahead
    prefetch_workers: int = 2               # parallel read/decompress threads
    stack_size: int = 4                     # tiles per pipelined stack
    # record every tile-skip decision into engine.skip_log (test aid)
    debug_skip_log: bool = False
    # byte budget of the out-of-core vertex state's in-memory tiers (hot
    # arrays + warm compressed blobs); beyond it, interval blocks spill to
    # disk.  None keeps the [V(, Q)] arrays fully resident.  Forces
    # engine_mode="tiled" (stacked/merged need the whole value array)
    vertex_memory_budget: Optional[int] = None
    # source intervals K; 0 = auto (about four value blocks fit the budget,
    # or the store's preprocessed interval plan when it has one)
    num_intervals: int = 0
    # out-of-core vertex state: order tiles for joint residency of edge
    # tiles and source intervals (cache-hit-first while footprints are
    # unknown, in superstep 0)
    interval_aware_order: bool = True
    # when set, this engine is ONE server of an N-server cluster: it runs
    # only rank ``server_rank`` of the stage-2 assignment and merges the
    # other servers' updates through the ClusterExchange passed to the
    # constructor.  None = one process emulating all N servers.
    server_rank: Optional[int] = None
    checkpoint_dir: Optional[str] = None    # ROADMAP.md A.10
    checkpoint_every: int = 0
    checkpoint_keep: int = 2
    resume: bool = False                    # ROADMAP.md A.10
    preemptible: bool = False               # ROADMAP.md A.10
    fault_plan: Optional[object] = None     # ROADMAP.md A.10
    # scripted admissions: (after_superstep, seeds) entries, each seeds
    # tuple spliced in as fresh query columns at the end of superstep
    # after_superstep, past the slot cap; ignored for 1-D programs
    admit_plan: Optional[tuple] = None
    # where tiles compute: "cuda" launches the kernels, "cpu" runs their
    # plain PyTorch versions (the tests)
    device: str = "cuda"

    def unsupported(self) -> list[str]:
        """The knobs set outside the port so far, each with the ROADMAP.md
        queue item that will bring it."""
        out = []
        checks = (
            (self.kernel_autotune,
             "kernel_autotune=True (roofline/kernel_tune.py)", "A.12"),
            (self.kernel_blocks is not None,
             "kernel_blocks (roofline/kernel_tune.py)", "A.12"),
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
    seconds wall-clock) — the reference's fields for runs in one
    process."""
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
    # time the compute loop spent blocked on tile data: all of the load
    # time in the serial loop, the residual wait behind prefetch when
    # pipelined
    stall_seconds: float = 0.0
    # disk read + (de)compress busy time this superstep, wherever it ran
    io_busy_seconds: float = 0.0
    # tiered-cache activity this superstep (zeros for policy="lru")
    cache_promotions: int = 0
    cache_demotions: int = 0
    # per-tier residency at the barrier: {tier: {tiles, bytes, hits}}
    cache_tiers: dict = dataclasses.field(default_factory=dict)
    # --- multi-query accounting (trivial for 1-D runs) ---
    # query columns still live when this superstep started
    active_queries: int = 1
    # updated (vertex, query) cells; == updated_vertices for 1-D runs
    updated_pairs: int = 0
    # {global query id: updated-cell count} for active queries
    updated_per_query: dict = dataclasses.field(default_factory=dict)
    # global query ids whose columns converged (and were compacted out)
    # at the end of this superstep
    retired_queries: tuple = ()
    # global query ids spliced in (admitted) at the end of this superstep;
    # their first compute superstep is the next one
    admitted_queries: tuple = ()
    # global query ids force-retired mid-flight (session drain) at the end
    # of this superstep; their per-query supersteps stay -1
    drained_queries: tuple = ()
    # --- out-of-core vertex state (zeros when in memory) ---
    vstate_faults: int = 0          # interval blocks decoded (warm + cold)
    vstate_load_bytes: int = 0      # compressed bytes faulted back in
    vstate_spill_bytes: int = 0     # compressed bytes written to disk
    vstate_dirty_intervals: int = 0 # intervals written back (and broadcast)


@dataclasses.dataclass
class RunResult:
    """Final vertex values [V(, Q)] + aux arrays + per-superstep history of
    one engine run."""
    values: np.ndarray
    aux: dict
    history: list[SuperstepStats]
    supersteps: int
    converged: bool
    # multi-query runs: supersteps each query column took to converge,
    # counted from its admission (index = global query id; -1 if it hit
    # max_supersteps or was drained); None for 1-D runs
    per_query_supersteps: Optional[np.ndarray] = None

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
    """The out-of-core superstep engine (see module docstring).

    One instance either emulates all ``cfg.num_servers`` servers in one
    process or — with ``cfg.server_rank`` set and a
    ``distributed.ClusterExchange`` passed as ``exchange`` (or assigned to
    ``engine.exchange`` before a run) — acts as one real server of a
    multi-process cluster, merging peer updates at the BSP barrier
    through the exchange.  Results are bit-identical either way: tiles
    own disjoint dst rows, the per-tile math is the same kernel, and
    update value bytes round-trip the wire exactly."""

    def __init__(self, store: TileStore, config: EngineConfig = EngineConfig(),
                 exchange=None):
        problems = config.unsupported()
        if problems:
            raise NotImplementedError("; ".join(problems))
        if config.seg_impl not in SEG_IMPLS:
            raise ValueError(
                f"seg_impl {config.seg_impl!r}: the port has "
                f"{', '.join(SEG_IMPLS)} (the reference's 'jnp' XLA "
                f"scatter has no counterpart on the card)")
        if config.engine_mode not in ENGINE_MODES:
            raise ValueError(f"engine_mode {config.engine_mode!r}: one of "
                             f"{', '.join(ENGINE_MODES)}")
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
        # cluster mode: this process executes exactly one server's share
        if config.server_rank is not None:
            if not 0 <= config.server_rank < N:
                raise ValueError(
                    f"server_rank {config.server_rank} outside 0..{N - 1}")
            self.exec_servers = [config.server_rank]
        else:
            self.exec_servers = list(range(N))
        self.exchange = exchange

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
        # stacked/merged: per-server device-resident tiles, built at the
        # first superstep that runs them; the tiles beyond the device budget
        # stream tiled
        self._stacks: Optional[dict] = None
        self._streamed: dict[int, list[int]] = {s: [] for s in self.exec_servers}
        #: filled when cfg.debug_skip_log: one dict per (superstep, server)
        #: with the active source ids and the run/skipped tile partition
        self.skip_log: list[dict] = []
        # comm_accounting="sampled": wire/raw ratio of the last measured step
        self._wire_ratio: Optional[float] = None
        # Per-superstep deltas are computed against these cumulative-counter
        # baselines; each session re-baselines them when it opens.
        self._io_busy_cum = 0.0
        self._promo_cum = 0
        self._demo_cum = 0
        self._disk_cum = 0
        # --- out-of-core vertex state (set here, not at session open: the
        # reference's kernel_plan returns before its lines for __init__)
        self._ooc = False
        #: the running session's interval-sharded VertexStateStore
        self.vstate: Optional[VertexStateStore] = None
        self._iv_splitter: Optional[np.ndarray] = None
        self._iv_t2i: Optional[np.ndarray] = None
        self._use_meta_fp = False
        self._tile_iv_ids: dict[int, frozenset] = {}
        self._vs_faults_cum = 0
        self._vs_load_cum = 0
        self._vs_spill_cum = 0

    @property
    def exchange(self):
        """The ``ClusterExchange`` this server merges its peers through at
        the barrier, or None."""
        return self._exchange

    @exchange.setter
    def exchange(self, exchange):
        # the barrier ships per_server_updates[0]: one executed server
        if exchange is not None and len(self.exec_servers) != 1:
            raise ValueError(
                "a ClusterExchange needs exactly one executed server per "
                "process — set cfg.server_rank (or num_servers=1)")
        self._exchange = exchange

    # ------------------------------------------------------------------
    def kernel_plan(self, prog) -> tuple[str, int]:
        """``(seg_impl, stack_size)`` for this program: the configured
        backend and the pipelined stack length (at least 1)."""
        return self.cfg.seg_impl, max(1, self.cfg.stack_size)

    @staticmethod
    def _split_updates(rows, new, upd):
        """Per-tile (or per-server) update extraction, shape-polymorphic.

        rows [R] global vertex ids; new/upd [R] or [R, Qa].  Returns
        (vertex ids with any update, their value rows, per-query mask rows
        or None for 1-D runs)."""
        if upd.ndim == 2:
            vmask = upd.any(axis=1)
            return rows[vmask], new[vmask], upd[vmask]
        return rows[upd], new[upd], None

    def open_session(self, prog: VertexProgram, *,
                     q_slots: Optional[int] = None,
                     max_supersteps: Optional[int] = None) -> "EngineSession":
        """Open a step-driven session over ``prog``: one ``session.step()``
        executes exactly one superstep, and between barriers the caller may
        ``admit()`` fresh queries into retired ``[V, Q]`` columns or
        ``drain()`` live ones.  ``q_slots`` caps the live query columns
        (default: the program's initial batch width); admissions beyond it
        queue until retirement frees a slot.  At most one out-of-core
        session may be live per engine at a time (sessions share the
        engine's edge caches, skip filters and interval bookkeeping)."""
        return EngineSession(self, prog, q_slots=q_slots,
                             max_supersteps=max_supersteps)

    def run(self, prog: VertexProgram,
            max_supersteps: Optional[int] = None) -> RunResult:
        """Run ``prog`` to convergence (no updated cells and no pending
        admission) or ``max_supersteps``, honouring ``cfg.admit_plan``;
        results are bit-identical across engine modes, pipelining, cache
        policies and out-of-core vertex state."""
        session = self.open_session(prog, max_supersteps=max_supersteps)
        try:
            while not session.finished:
                session.step()
            return session.result()
        finally:
            session.close()

    # ------------------------------------------------------------------
    def _measure_broadcast(self, si, sv, sm, nv, qa, dtype, background=False):
        """Build one server's broadcast payload and measure its wire size —
        inline (returns a BroadcastRecord) or on the comm executor
        (returns a Future resolving to one).  ``sm`` is the per-query
        updated mask ``[len(si), qa]`` of multi-query runs or None; the
        2-D payload then covers the ``qa`` live query columns.

        Out-of-core vertex state ships one section per dirty interval,
        built from the sparse update lists (no ``[V, Q]`` buffer)."""
        cfg = self.cfg
        if self._ooc:
            plan = (comm.plan_broadcast_intervals_async if background
                    else comm.plan_broadcast_intervals)
            return plan(si, sv, sm, self._iv_splitter,
                        threshold=cfg.comm_threshold,
                        compressor=cfg.comm_compressor, mode=cfg.comm_mode)
        if sm is not None:
            upd_mask = np.zeros((nv, qa), dtype=bool)
            upd_mask[si] = sm
            values = np.zeros((nv, qa), dtype=dtype)
        else:
            upd_mask = np.zeros(nv, dtype=bool)
            upd_mask[si] = True
            values = np.zeros(nv, dtype=dtype)
        values[si] = sv
        plan = comm.plan_broadcast_async if background else comm.plan_broadcast
        return plan(values, upd_mask, threshold=cfg.comm_threshold,
                    compressor=cfg.comm_compressor, mode=cfg.comm_mode)

    # ------------------------------------------------------------------
    # pipelined path (cfg.pipeline): prefetch threads + stacked dispatch
    # ------------------------------------------------------------------
    def _run_tiles_pipelined(self, s, tids, prog, values_dev, aux_dev,
                             filters, nv):
        """Overlapped tile processing for one server.

        Background threads read + decompress up to ``prefetch_depth`` tiles
        ahead through the server's EdgeCache (numpy tiles only: CUDA
        tensors stay on this thread) while this thread stacks
        ``stack_size`` tiles and runs them as one ``run_tile_stack`` call,
        merging each stack's result on the device.  Its queue wait is the
        disk stall the pipeline failed to hide.

        Returns ([indices], [values], [query masks], load_s, compute_s,
        stall_s), the per-row results of the serial per-tile loop (tiles
        own disjoint row ranges).  The query-mask list is empty for 1-D
        runs."""
        cfg = self.cfg
        if not tids:
            return [], [], [], 0.0, 0.0, 0.0
        if self._ooc:
            # out-of-core vertex state: the prefetcher still reads edge
            # tiles ahead, but tiles run one at a time through the sharded
            # step (a stack would need the whole value array on the device)
            return self._run_tiles_pipelined_ooc(s, tids, prog, filters, nv)
        row_cap = self.plan.row_cap
        seg_impl, stack_k = self.kernel_plan(prog)
        load_s = comp_s = stall_s = 0.0
        masked_acc = upd_acc = None
        batch: list = []

        def flush():
            nonlocal comp_s, masked_acc, upd_acc, batch
            stk = stack_tiles(batch, row_cap)
            if len(batch) < stack_k:
                stk = pad_stack_to(stk, stack_k)  # every stack K tiles long
            t0 = time.perf_counter()
            new_masked, upd = run_tile_stack(prog, values_dev, aux_dev, stk,
                                             row_cap, seg_impl)
            if masked_acc is None:
                masked_acc, upd_acc = new_masked, upd
            else:  # disjoint row ranges: set-where-updated merge is exact
                masked_acc = torch.where(upd, new_masked, masked_acc)
                upd_acc = upd_acc | upd
            comp_s += time.perf_counter() - t0
            batch = []

        it = self.store.prefetch_iter(tids, depth=cfg.prefetch_depth,
                                      cache=self.caches[s],
                                      workers=cfg.prefetch_workers)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    tid, tile = next(it)
                except StopIteration:
                    break
                wait = time.perf_counter() - t0
                load_s += wait
                stall_s += wait
                if filters is not None and filters[tid] is None:
                    filters[tid] = self._make_filter(tile, nv)
                batch.append(tile)
                if len(batch) == stack_k:
                    flush()
            if batch:
                flush()
        finally:
            it.close()

        t0 = time.perf_counter()
        si, sv, sm = self._split_updates(np.arange(nv),
                                         masked_acc.cpu().numpy(),
                                         upd_acc.cpu().numpy())
        comp_s += time.perf_counter() - t0
        return [si], [sv], [] if sm is None else [sm], load_s, comp_s, stall_s

    # ------------------------------------------------------------------
    # stacked / merged modes: device-resident tiles
    # ------------------------------------------------------------------
    def _build_stacks(self) -> None:
        """Per-server device-resident tile stacks for
        ``engine_mode="stacked"``: up to ``device_budget_bytes`` of tiles
        per server live on the device; the rest stream per superstep."""
        per_tile = self.plan.edge_cap * 12  # src + dst + val
        fit = max(1, self.cfg.device_budget_bytes // per_tile)
        self._stacks = {}
        for s in self.exec_servers:
            resident = self.assignment[s][:fit]
            self._streamed[s] = self.assignment[s][fit:]
            tiles = [self.caches[s].get(t) for t in resident]
            self._stacks[s] = stack_to_device(
                stack_tiles(tiles, self.plan.row_cap), self.device)

    def _build_merged(self, nv: int) -> None:
        """Per-server merged edge lists for ``engine_mode="merged"``: every
        real edge of the server's tiles, dst global and ascending (the
        segment kernel binary-searches it), plus the owned-row mask."""
        self._stacks = {}
        for s in self.exec_servers:
            self._streamed[s] = []
            srcs, dsts, vals = [], [], []
            owned = np.zeros(nv, dtype=bool)
            for tid in self.assignment[s]:
                t = self.caches[s].get(tid)
                n = t.meta.num_edges
                srcs.append(t.src[:n])
                dsts.append(t.dst_local[:n].astype(np.int64)
                            + t.meta.row_start)
                vals.append(tile_edge_values(t)[:n])
                owned[t.meta.row_start: t.meta.row_end] = True
            dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
            # tiles own ascending, disjoint row ranges and each server's
            # list is sorted (partition.assign_tiles*), so this holds; the
            # kernel would silently misreduce if it did not
            if not np.all(dst[1:] >= dst[:-1]):
                raise ValueError(f"server {s}: merged dst list is not "
                                 "ascending (tiles out of row order)")

            def dev(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(
                    self.device)

            self._stacks[s] = dict(
                src=dev(np.concatenate(srcs).astype(np.int32)),
                dst=dev(dst.astype(np.int32)),
                val=dev(np.concatenate(vals).astype(np.float32)),
                owned=dev(owned))

    def _stack_step(self, prog, values_dev, aux_dev, stack):
        seg_impl, _ = self.kernel_plan(prog)
        return stacked_tiles_step(prog, values_dev, aux_dev, stack,
                                  self.plan.row_cap, seg_impl)

    def _merged_step(self, prog, values_dev, aux_dev, m):
        seg_impl, _ = self.kernel_plan(prog)
        return merged_server_step(prog, values_dev, aux_dev, m["src"],
                                  m["dst"], m["val"], m["owned"], seg_impl)

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    # out-of-core vertex state
    # ------------------------------------------------------------------
    def _build_vstate(self, values: np.ndarray,
                      aux_np: dict) -> VertexStateStore:
        """Shard the freshly initialized ``[V(, Q)]`` arrays into an
        interval-sharded store under ``cfg.vertex_memory_budget``, its
        spill directory inside the tile store."""
        cfg = self.cfg
        stored = self.store.load_interval_plan()
        if cfg.num_intervals:
            k = cfg.num_intervals
        else:
            # auto: about four blocks of the whole per-vertex state fit
            # the budget, so a gather can hold its dst block and several
            # source blocks hot
            total = values.nbytes + sum(a.nbytes for a in aux_np.values())
            k = max(2, int(np.ceil(total / max(cfg.vertex_memory_budget / 4,
                                               1))))
        if stored is not None and (cfg.num_intervals == 0
                                   or stored.num_intervals == cfg.num_intervals):
            iv = stored   # the tiles' footprint metadata refers to its cuts
        else:
            iv = plan_intervals(self.plan.splitter, k)
        self._use_meta_fp = (stored is not None
                             and np.array_equal(iv.splitter, stored.splitter))
        self._iv_splitter = iv.splitter
        self._iv_t2i = iv.tile_to_interval
        self._tile_iv_ids = {}
        spill_dir = tempfile.mkdtemp(prefix="_vstate_", dir=self.store.root)
        vstore = VertexStateStore(iv.splitter, cfg.vertex_memory_budget,
                                  spill_dir)
        self.vstate = vstore
        vstore.add_array("value", values)
        for name, arr in aux_np.items():
            vstore.add_array(name, arr)
        return vstore

    def _tile_footprint(self, tile):
        """(interval ids, cumulative edge ptr, bucket-sort permutation) of
        one tile's sources — from its metadata when the store was
        preprocessed with this interval plan, else computed here."""
        m = tile.meta
        if (self._use_meta_fp and m.src_intervals is not None
                and tile.iv_perm is not None):
            ids, ptr, perm = m.src_intervals, m.src_interval_ptr, tile.iv_perm
        else:
            ids, ptr, perm = compute_source_footprint(
                tile.src, m.num_edges, self._iv_splitter)
        # the joint footprint (source intervals + dst interval), for the
        # co-scheduler
        self._tile_iv_ids[m.tile_id] = (
            frozenset(ids) | {int(self._iv_t2i[m.tile_id])})
        return ids, ptr, perm

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """A zeroed host tensor for one gathered input; page-locked when
        the tiles compute on a CUDA device, so its copy is one DMA (torch's
        pinned pool reuses the memory once that copy is done)."""
        return torch.zeros(shape,
                           dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                           pin_memory=self.device.type == "cuda")

    def _ooc_tile_step(self, prog, tile, nv):
        """One tile's Gather+Apply against the interval-sharded vertex
        state: fill the per-edge source inputs interval by interval on the
        host, slice the dst rows from the tile's own interval block, run
        ``run_tile_sharded`` on the device.  Returns the same (ids,
        values, query-mask) update triple as the in-memory path, bit for
        bit (see ``gab.tile_gather_apply_sharded``)."""
        vstore = self.vstate
        m = tile.meta
        row_cap = self.plan.row_cap
        with torch.profiler.record_function("vstate_gather"):
            ids, ptr, perm = self._tile_footprint(tile)
            names = ("value",) + tuple(prog.src_aux)
            bufs = {}
            for name in names:
                dt, tail = vstore.spec(name)
                bufs[name] = self._host_buffer((m.edge_cap,) + tail, dt)
            views = {name: b.numpy() for name, b in bufs.items()}
            src = tile.src
            for j, iv in enumerate(ids):
                sl = perm[ptr[j]: ptr[j + 1]]
                lo, _hi = vstore.interval_range(int(iv))
                local = src[sl] - lo
                for name in names:
                    views[name][sl] = vstore.get_block(name, int(iv))[local]
            ivd = int(self._iv_t2i[m.tile_id])
            lo_d, _hi_d = vstore.interval_range(ivd)
            r0, r1 = m.row_start - lo_d, m.row_end - lo_d
            vdt, vtail = vstore.spec("value")
            old = self._host_buffer((row_cap,) + vtail, vdt)
            old.numpy()[: m.num_rows] = vstore.get_block("value", ivd)[r0:r1]
            dst_aux = {}
            for name in prog.dst_aux:
                dt, tail = vstore.spec(name)
                buf = self._host_buffer((row_cap,) + tail, dt)
                buf.numpy()[: m.num_rows] = vstore.get_block(name, ivd)[r0:r1]
                dst_aux[name] = buf
        seg_impl, _ = self.kernel_plan(prog)
        new, upd = run_tile_sharded(
            prog, bufs["value"], {k: bufs[k] for k in prog.src_aux},
            tile_edge_values(tile), tile.dst_local, old, dst_aux,
            m.num_rows, row_cap, seg_impl, self.device)
        rows = np.minimum(m.row_start + np.arange(row_cap), nv - 1)
        return self._split_updates(rows, new.cpu().numpy(),
                                   upd.cpu().numpy())

    def _ooc_column(self, vstore: VertexStateStore, c: int) -> np.ndarray:
        """Assemble live query column ``c`` of the sharded value array."""
        return np.concatenate(
            [vstore.get_block("value", k)[:, c]
             for k in range(vstore.num_intervals)])

    def _run_tiles_pipelined_ooc(self, s, tids, prog, filters, nv):
        """The pipelined loop under out-of-core vertex state: tiles come
        from the prefetcher and run one at a time through
        ``_ooc_tile_step``.  Same return as ``_run_tiles_pipelined``."""
        cfg = self.cfg
        load_s = comp_s = stall_s = 0.0
        s_idx: list = []
        s_val: list = []
        s_msk: list = []
        it = self.store.prefetch_iter(tids, depth=cfg.prefetch_depth,
                                      cache=self.caches[s],
                                      workers=cfg.prefetch_workers)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    tid, tile = next(it)
                except StopIteration:
                    break
                wait = time.perf_counter() - t0
                load_s += wait
                stall_s += wait
                if filters is not None and filters[tid] is None:
                    filters[tid] = self._make_filter(tile, nv)
                t0 = time.perf_counter()
                ri, rv, rm = self._ooc_tile_step(prog, tile, nv)
                comp_s += time.perf_counter() - t0
                s_idx.append(ri)
                s_val.append(rv)
                if rm is not None:
                    s_msk.append(rm)
        finally:
            it.close()
        return s_idx, s_val, s_msk, load_s, comp_s, stall_s

    def _order_joint_residency(self, s: int, tids: list[int]) -> list[int]:
        """Interval-aware co-scheduling: greedily pick the tile whose joint
        footprint (source intervals + dst interval) overlaps most with a
        simulated LRU set of hot vertex intervals, then the one nearest
        the previous pick's dst interval, then edge-cache residency.  Order
        never changes results (disjoint rows, BSP barrier).  Falls back to
        cache-hit-first while footprints are unknown (superstep 0), and to
        :meth:`_order_interval_sweep` past 256 tiles."""
        fps = self._tile_iv_ids
        if any(t not in fps for t in tids):
            return self._order_cache_first(s, tids)
        if len(tids) > 256:
            # the greedy is O(T^2); past a few hundred tiles its Python cost
            # rivals the tile compute, and on locality-structured inputs it
            # sweeps contiguously from the hot end anyway
            return self._order_interval_sweep(tids)
        cache = self.caches[s]
        cap = max(1, self.vstate.hot_block_capacity("value"))
        sim: OrderedDict[int, None] = OrderedDict(
            (k, None) for k in sorted(self.vstate.hot_intervals("value")))
        edge_res = {t for t in tids if cache.contains(t)}
        ivd = {t: int(self._iv_t2i[t]) for t in tids}
        last: Optional[int] = None
        remaining = list(tids)
        order: list[int] = []
        while remaining:
            best, best_score = None, None
            for t in remaining:
                # a contiguous sweep keeps the faults at ~K - cap a pass;
                # scattered resident edge tiles pulling the walk around
                # cost more vertex faults than they save edge decodes
                score = (len(fps[t] & sim.keys()),
                         -abs(ivd[t] - last) if last is not None else 0,
                         t in edge_res)
                if best_score is None or score > best_score:
                    best, best_score = t, score
            order.append(best)
            remaining.remove(best)
            last = ivd[best]
            for ivk in sorted(fps[best]):
                sim.pop(ivk, None)
                sim[ivk] = None
            while len(sim) > cap:
                sim.popitem(last=False)
        return order

    def _order_interval_sweep(self, tids: list[int]) -> list[int]:
        """O(T log T) co-scheduling for large fleets: tiles sorted by dst
        interval, swept from the end where the hot intervals sit, so
        alternate supersteps sweep back and forth instead of rewinding to
        vertex 0 against the LRU."""
        hot = self.vstate.hot_intervals("value")
        order = sorted(tids, key=lambda t: int(self._iv_t2i[t]))
        if not hot:
            return order
        mid = (self._iv_t2i[order[0]] + self._iv_t2i[order[-1]]) / 2.0
        if np.mean(sorted(hot)) > mid:   # hot mass sits at the high end
            order.reverse()
        return order

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
    """Step-driven run state over one :class:`OutOfCoreEngine`.

    One ``step()`` call executes exactly one superstep — compute, BSP
    barrier, update apply, query retirement, drains and admissions — and
    between barriers a batched session takes **mid-run query admission**:
    ``admit(seeds)`` queues fresh queries that are spliced into ``[V, Q]``
    columns at a barrier (the inverse of retirement's column compaction),
    and ``drain(qids)`` force-retires live columns.  ``run()`` is a loop
    over a session.

    State machine: OPEN --step()*--> FINISHED --result()--> closed.  A
    session is FINISHED when it converged with no admission backlog, or
    hit ``max_supersteps``.  ``result()`` flushes live columns, closes the
    out-of-core spill tier and returns the :class:`RunResult`.

    At each barrier, in every execution mode (so results stay
    bit-identical across them):

    1. natural retirement — columns with zero updated cells freeze into
       the result buffer and compact out;
    2. drains — force-frozen columns (``per_query_supersteps`` stays -1);
    3. admissions — ``admit_plan`` entries due at this barrier (past the
       slot cap), then queued ``admit()`` seeds into free slots: fresh
       columns built by ``prog.with_queries(seeds).init`` splice into the
       values, the per-query aux and ``active_q``, and the next superstep
       runs every tile (``_force_full``), since the skip filters have not
       seen the new column.

    In cluster mode rank 0 collects the drains and admissions before the
    exchange and ships them in its frame; every rank settles that record
    after its natural retirement, so the columns spliced, and the slots
    they fill, are the same on every rank and in every mode.

    Thread safety: ``admit()``/``drain()`` may be called from any thread
    while ``step()`` runs; ``step()``/``result()`` from one driver
    thread.
    """

    #: lock discipline: the admission and drain queues are filled by a
    #: submitting thread while the driver thread splices them at the barrier
    _guarded_by = {"_admit_queue": "_lock", "_drain_queue": "_lock",
                   "next_qid": "_lock"}

    def __init__(self, engine: OutOfCoreEngine, prog: VertexProgram, *,
                 q_slots: Optional[int] = None,
                 max_supersteps: Optional[int] = None):
        self.eng = engine
        self.prog = prog
        cfg = engine.cfg
        nv = self.nv = engine.plan.num_vertices
        self._lock = threading.Lock()
        self._admit_queue: list[tuple[int, int]] = []
        self._drain_queue: list[int] = []
        self._force_full = False
        self._final_result: Optional[RunResult] = None
        self._closed = False
        self.history: list[SuperstepStats] = []
        self.converged = False
        self.finished = False
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
        self.aux_np = {k: np.asarray(v) for k, v in state.items()}
        self.vdtype = self.values.dtype

        # Multi-query bookkeeping: values [V, Q] hold Q program instances.
        # A query column with zero updates in a superstep has reached its
        # fixpoint: it is written to final_values and compacted out of the
        # live state, and its slot is what admission refills.
        self.multi_q = self.values.ndim == 2
        self.nq_total = self.values.shape[1] if self.multi_q else 1
        self.active_q = np.arange(self.nq_total)  # global ids, live columns
        self.final_values = self.values.copy() if self.multi_q else None
        self.per_query_ss = (np.full(self.nq_total, -1, dtype=np.int64)
                             if self.multi_q else None)
        #: superstep each column's compute began at (0 for the initial
        #: queries): per_query_ss counts from it, so an admitted query
        #: reports the same count as a fresh run
        self.admitted_at = (np.zeros(self.nq_total, dtype=np.int64)
                            if self.multi_q else None)
        #: {global qid: seed vertex} for every column ever admitted
        self.query_seeds: dict[int, int] = {
            int(i): int(s)
            for i, s in enumerate(getattr(prog, "queries", ()))}
        self.next_qid = self.nq_total if self.multi_q else 1
        self.q_slots = (max(1, int(q_slots)) if q_slots is not None
                        else max(1, self.nq_total))
        self._plan_pending: list[tuple[int, tuple]] = (
            [(int(after), tuple(int(s) for s in seeds))
             for after, seeds in (cfg.admit_plan or ())]
            if self.multi_q else [])

        # Out-of-core vertex state: the [V(, Q)] arrays move into an
        # interval-sharded VertexStateStore and the full arrays are
        # dropped.  stacked/merged need the whole value array on the
        # device, so it forces tiled.
        self._ooc = engine._ooc = cfg.vertex_memory_budget is not None
        self.engine_mode = "tiled" if self._ooc else cfg.engine_mode
        self.vstore: Optional[VertexStateStore] = None
        if self._ooc:
            self.vstore = engine._build_vstate(self.values, self.aux_np)
            engine._vs_faults_cum = self.vstore.stats.faults
            engine._vs_load_cum = self.vstore.stats.load_bytes
            engine._vs_spill_cum = self.vstore.stats.spill_bytes
            self.values = None
            self.aux_np = {}
            self.aux_dev = None
        else:
            self.aux_dev = {k: self._to_device(v)
                            for k, v in self.aux_np.items()}

        self.max_ss = max_supersteps or cfg.max_supersteps
        self.updated_ids = np.arange(nv)  # everything "updated" pre step 0
        self.building_filters = cfg.tile_skipping
        self.filters: list = ([None] * engine.plan.num_tiles
                              if self.building_filters else [])

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.eng.device)

    # -- public session surface ----------------------------------------------
    @property
    def superstep(self) -> int:
        """Index of the next superstep ``step()`` will execute."""
        return self._ss

    @property
    def active_queries(self) -> tuple[int, ...]:
        """Global qids of the live query columns."""
        return tuple(int(g) for g in self.active_q) if self.multi_q else ()

    @property
    def free_slots(self) -> int:
        """Query slots available for admission right now."""
        if not self.multi_q:
            return 0
        with self._lock:
            queued = len(self._admit_queue)
        return max(0, self.q_slots - len(self.active_q) - queued)

    def admit(self, seeds) -> list[int]:
        """Queue fresh queries (seed vertices) for admission at the next
        barrier; returns their global qids.  Thread-safe.  Queries beyond
        the free ``q_slots`` stay queued until retirement frees slots.
        Cluster mode: rank 0 only (peers follow its control record)."""
        if not self.multi_q:
            raise RuntimeError("admission needs a batched [V, Q] program")
        if self.eng.exchange is not None and self.eng.exchange.rank != 0:
            raise RuntimeError("cluster admissions originate at rank 0 — "
                               "peers splice from the control record")
        if self.finished:
            raise RuntimeError("session is finished")
        with self._lock:
            gqs = []
            for s in seeds:
                g = self.next_qid
                self.next_qid += 1
                self._admit_queue.append((g, int(s)))
                gqs.append(g)
        return gqs

    def drain(self, qids) -> None:
        """Force-retire live columns at the next barrier: their partial
        values freeze into the result and ``per_query_supersteps`` stays
        -1.  Thread-safe."""
        with self._lock:
            self._drain_queue.extend(int(g) for g in qids)

    def query_result(self, gq: int) -> np.ndarray:
        """The frozen ``[V]`` column of query ``gq`` — valid once it
        retired or drained; before that it holds its admission-time
        state."""
        return np.asarray(self.final_values[:, int(gq)]).copy()

    def query_supersteps(self, gq: int) -> int:
        """Supersteps query ``gq`` took to converge, counted from its own
        admission (a fresh single-query run's count); -1 while live or if
        it was drained."""
        return int(self.per_query_ss[int(gq)])

    def close(self) -> None:
        """Release the run's scratch (the out-of-core spill tier).
        Idempotent; ``result()`` already closed the store."""
        if self._closed:
            return
        self._closed = True
        if self.vstore is not None and self._final_result is None:
            self.vstore.close()

    # -- the superstep ------------------------------------------------------
    def step(self) -> SuperstepStats:
        """Execute exactly one superstep (compute → barrier → apply →
        retirement → drains → admissions) and return its stats."""
        if self.finished:
            raise RuntimeError("session is finished — open a new one")
        eng = self.eng
        cfg = eng.cfg
        prog = self.prog
        nv = self.nv
        ooc = self._ooc
        multi_q = self.multi_q
        vstore = self.vstore
        vdtype = self.vdtype
        row_cap = eng.plan.row_cap
        filters = self.filters
        building_filters = self.building_filters
        ss = self._ss

        t_start = time.perf_counter()
        qa = len(self.active_q) if multi_q else 1  # live columns this step
        # a batched session with zero live columns still steps (waiting on
        # scheduled or queued admissions): the barrier runs, no tile does
        run_compute = not (multi_q and qa == 0)
        # in memory, the values go to the device once a superstep
        values_dev = (None if (ooc or not run_compute)
                      else self._to_device(self.values))
        load_s = 0.0
        comp_s = 0.0
        stall_s = 0.0
        tiles_done = 0
        tiles_skipped = 0
        upd_idx_parts: list[np.ndarray] = []
        upd_val_parts: list[np.ndarray] = []
        upd_msk_parts: list[np.ndarray] = []
        per_server_updates: list[tuple] = []
        bcast_futures: dict[int, object] = {}
        # "sampled": measure every 4th superstep, estimate the rest from
        # the update count and the last measured wire/raw ratio; the
        # out-of-core payloads always measure (the estimator models one
        # whole-V payload, not per-interval sections)
        sample = ooc or not (cfg.comm_accounting == "sampled"
                             and ss % 4 != 0
                             and eng._wire_ratio is not None)

        # a column admitted at the previous barrier is all-dirty for one
        # superstep: run every tile once (the filters have no false
        # negatives, so a full pass only adds work), then skip again
        force_full = self._force_full
        self._force_full = False
        skip_on = (
            cfg.tile_skipping
            and ss > 0
            and not force_full
            and len(self.updated_ids) < cfg.skip_density_threshold * nv
            and eng._filters is not None
        )
        active_words = None
        if skip_on and cfg.skip_filter == "bitmap":
            active_words = SourceBlockBitmap.active_words_from_ids(
                self.updated_ids, nv, cfg.block_shift
            )

        for s in (eng.exec_servers if run_compute else ()):
            s_idx: list[np.ndarray] = []
            s_val: list[np.ndarray] = []
            s_msk: list[np.ndarray] = []
            server_tiles = eng.assignment[s]
            if self.engine_mode in ("stacked", "merged") and not skip_on:
                if eng._stacks is None:
                    t0 = time.perf_counter()
                    if self.engine_mode == "merged":
                        eng._build_merged(nv)
                    else:
                        eng._build_stacks()
                    if building_filters:
                        for st in eng.exec_servers:
                            n_res = (len(eng.assignment[st])
                                     - len(eng._streamed[st]))
                            for tid in eng.assignment[st][:n_res]:
                                if filters[tid] is None:
                                    filters[tid] = eng._make_filter(
                                        eng.caches[st].get(tid), nv)
                    load_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                step_fn = (eng._merged_step if self.engine_mode == "merged"
                           else eng._stack_step)
                new_masked, upd = step_fn(prog, values_dev, self.aux_dev,
                                          eng._stacks[s])
                si, sv, sm = eng._split_updates(
                    np.arange(nv), new_masked.cpu().numpy(),
                    upd.cpu().numpy())
                comp_s += time.perf_counter() - t0
                s_idx.append(si)
                s_val.append(sv)
                if sm is not None:
                    s_msk.append(sm)
                tiles_done += len(eng.assignment[s]) - len(eng._streamed[s])
                server_tiles = eng._streamed[s]

            # Tile-skipping pre-pass: the filter set is fixed for the whole
            # superstep, so the survivor list is computed up front (and
            # handed to the prefetcher when pipelined).
            if skip_on:
                run_list = []
                for tid in server_tiles:
                    f = eng._filters[tid]
                    # a tile stolen from a peer has no filter here: run it
                    hit = (f is None
                           or (f.intersects(active_words)
                               if cfg.skip_filter == "bitmap"
                               else f.might_contain_any(self.updated_ids)))
                    if hit:
                        run_list.append(tid)
                    else:
                        tiles_skipped += 1
                if cfg.debug_skip_log:
                    eng.skip_log.append(dict(
                        superstep=ss, server=s,
                        active=np.asarray(self.updated_ids).copy(),
                        run=list(run_list),
                        skipped=[t for t in server_tiles
                                 if t not in run_list]))
            else:
                run_list = list(server_tiles)
            if ooc and cfg.interval_aware_order and len(run_list) > 1:
                run_list = eng._order_joint_residency(s, run_list)
            elif cfg.cache_aware_order and len(run_list) > 1:
                run_list = eng._order_cache_first(s, run_list)

            if cfg.pipeline:
                p_idx, p_val, p_msk, ld, cp, stl = eng._run_tiles_pipelined(
                    s, run_list, prog, values_dev, self.aux_dev,
                    filters if building_filters else None, nv)
                s_idx += p_idx
                s_val += p_val
                s_msk += p_msk
                load_s += ld
                comp_s += cp
                stall_s += stl
                tiles_done += len(run_list)
            else:
                seg_impl, _ = eng.kernel_plan(prog)
                for tid in run_list:
                    t0 = time.perf_counter()
                    tile = eng.caches[s].get(tid)
                    dt = time.perf_counter() - t0
                    load_s += dt
                    stall_s += dt   # serial: every load blocks compute

                    if building_filters and filters[tid] is None:
                        filters[tid] = eng._make_filter(tile, nv)

                    t0 = time.perf_counter()
                    if ooc:
                        ri, rv, rm = eng._ooc_tile_step(prog, tile, nv)
                    else:
                        rows, new, upd = run_tile(
                            prog, values_dev, self.aux_dev,
                            (tile.src, tile.dst_local,
                             tile_edge_values(tile)),
                            tile.meta.row_start, tile.meta.num_rows,
                            row_cap, seg_impl,
                        )
                        ri, rv, rm = eng._split_updates(
                            rows.cpu().numpy(), new.cpu().numpy(),
                            upd.cpu().numpy())
                    comp_s += time.perf_counter() - t0
                    s_idx.append(ri)
                    s_val.append(rv)
                    if rm is not None:
                        s_msk.append(rm)
                    tiles_done += 1
            val_shape = (0, qa) if multi_q else (0,)
            si = np.concatenate(s_idx) if s_idx else np.zeros(0, np.int64)
            sv = (np.concatenate(s_val) if s_val
                  else np.zeros(val_shape, vdtype))
            sm = None
            if multi_q:
                sm = (np.concatenate(s_msk) if s_msk
                      else np.zeros(val_shape, dtype=bool))
            per_server_updates.append((si, sv, sm))
            upd_idx_parts.append(si)
            upd_val_parts.append(sv)
            if multi_q:
                upd_msk_parts.append(sm)
            if cfg.pipeline and sample and eng.exchange is None:
                # overlap this server's payload compression with the next
                # server's compute; the records are collected at the barrier
                # (cluster mode measures the frames that travel instead)
                bcast_futures[s] = eng._measure_broadcast(
                    si, sv, sm, nv, qa, vdtype, background=True)

        if not run_compute:
            for _ in eng.exec_servers:
                per_server_updates.append((np.zeros(0, np.int64),
                                           np.zeros((0, qa), vdtype),
                                           np.zeros((0, qa), dtype=bool)))

        own_tiles = [t for s in eng.exec_servers for t in eng.assignment[s]]
        if building_filters and all(filters[t] is not None
                                    for t in own_tiles):
            eng._filters = filters
            self.building_filters = False

        # --- Broadcast (BSP barrier): measure payloads, apply updates ---
        raw_b = wire_b = 0
        control = None
        if eng.exchange is not None:
            # cluster mode: ship this server's updates through the real
            # transport and merge every peer's frame — the exchange IS the
            # global barrier, and the byte counts are the frames that
            # travelled.  Rank 0's admission/drain record rides its frame:
            # collected before the exchange, settled against this
            # barrier's retirement by every rank below.
            if eng.exchange.rank == 0:
                control = self._collect_control(ss)
            si, sv, sm = per_server_updates[0]
            xr = eng.exchange.exchange(
                idx=si, vals=sv, mask=sm, nv=nv,
                splitter=eng._iv_splitter if ooc else None,
                compute_seconds=comp_s, control=control)
            control = xr.control
            all_idx, all_val, all_msk = xr.idx, xr.vals, xr.mask
            raw_b, wire_b = xr.raw_bytes, xr.wire_bytes
            if xr.assignment is not None:
                # cross-server tile stealing: every server derived the
                # same new ownership from the same replicated timings
                eng.assignment = [list(a) for a in xr.assignment]
        else:
            for s, (si, sv, sm) in zip(eng.exec_servers,
                                       per_server_updates):
                if not run_compute:
                    break
                if sample:
                    rec = (bcast_futures[s].result() if s in bcast_futures
                           else eng._measure_broadcast(si, sv, sm, nv, qa,
                                                       vdtype))
                    raw_b += rec.raw_bytes
                    wire_b += rec.wire_bytes
                else:
                    pairs = int(sm.sum()) if sm is not None else len(si)
                    n_eff = nv * qa
                    est = comm.wire_bytes_estimate(
                        n_eff, pairs / max(n_eff, 1),
                        # 2-D sparse payloads pack (vertex, query) u32 pairs
                        index_bytes=8 if sm is not None else 4)
                    raw_b += est
                    wire_b += int(est * eng._wire_ratio)
            if sample and raw_b:
                eng._wire_ratio = wire_b / raw_b
            all_idx = (np.concatenate(upd_idx_parts) if upd_idx_parts
                       else np.zeros(0, np.int64))
            all_val = (np.concatenate(upd_val_parts) if upd_val_parts
                       else np.zeros((0, qa) if multi_q else (0,), vdtype))
            all_msk = None
            if multi_q:
                all_msk = (np.concatenate(upd_msk_parts) if upd_msk_parts
                           else np.zeros((0, qa), dtype=bool))
        if multi_q:
            upd_per_q = all_msk.sum(axis=0)
            updated_pairs = int(all_msk.sum())
        else:
            updated_pairs = int(len(all_idx))
        dirty_ivs = 0
        if ooc:
            # dirty-interval writeback: only the interval blocks that
            # received updates are loaded, updated and written back
            with torch.profiler.record_function("vstate_writeback"):
                if len(all_idx):
                    ivs = vstore.interval_of(all_idx)
                    for iv in np.unique(ivs):
                        ksel = ivs == iv
                        lo, _hi = vstore.interval_range(int(iv))
                        blk = vstore.get_block("value", int(iv)).copy()
                        loc = all_idx[ksel] - lo
                        if multi_q:
                            # per-cell application: a row touched by query
                            # A must not clobber query B's column
                            cur = blk[loc]
                            msk = all_msk[ksel]
                            cur[msk] = all_val[ksel][msk]
                            blk[loc] = cur
                        else:
                            blk[loc] = all_val[ksel]
                        vstore.write_block("value", int(iv), blk)
                        dirty_ivs += 1
        elif multi_q:
            # per-cell application: a row touched by query A must not
            # clobber query B's column with a masked zero / sub-tol value
            cur = self.values[all_idx]
            cur[all_msk] = all_val[all_msk]
            self.values[all_idx] = cur
        else:
            self.values[all_idx] = all_val
        self.updated_ids = all_idx

        # Re-tier at the barrier: off the tile hot path, after this
        # superstep's access pattern has updated the per-tile counters.
        if cfg.cache_policy != "lru":
            for c in eng.caches.values():
                c.maintain()

        cache_stats = eng._agg_cache_stats()
        io_busy = cache_stats["io_seconds"] - eng._io_busy_cum
        eng._io_busy_cum = cache_stats["io_seconds"]
        promo = cache_stats["promotions"] - eng._promo_cum
        demo = cache_stats["demotions"] - eng._demo_cum
        eng._promo_cum = cache_stats["promotions"]
        eng._demo_cum = cache_stats["demotions"]
        disk_b = cache_stats["disk_bytes_read"] - eng._disk_cum
        eng._disk_cum = cache_stats["disk_bytes_read"]
        vs_faults = vs_load = vs_spill = 0
        if ooc:
            vst = vstore.stats
            vs_faults = vst.faults - eng._vs_faults_cum
            vs_load = vst.load_bytes - eng._vs_load_cum
            vs_spill = vst.spill_bytes - eng._vs_spill_cum
            eng._vs_faults_cum = vst.faults
            eng._vs_load_cum = vst.load_bytes
            eng._vs_spill_cum = vst.spill_bytes

        # --- barrier bookkeeping: natural retirement → drains → admissions
        retired: tuple = ()
        drained: tuple = ()
        admitted: tuple = ()
        upd_map: dict = {}
        ctl_pending = 0
        if multi_q:
            upd_map = {int(g): int(n)
                       for g, n in zip(self.active_q, upd_per_q)}
            done = np.nonzero(upd_per_q == 0)[0]
            retired = tuple(int(self.active_q[c]) for c in done)
            if eng.exchange is None:
                control = self._collect_control(ss)
            # settled after retirement, in every mode: a slot freed at
            # this barrier refills at this same barrier
            live = set(self.active_queries) - set(retired)
            ctl_admit, ctl_drain, ctl_pending = self._settle_control(
                control, live)
            drained = tuple(g for g in ctl_drain if g in live)
            freeze = sorted(set(int(c) for c in done)
                            | {int(np.nonzero(self.active_q == g)[0][0])
                               for g in drained})
            if freeze:
                self._freeze(freeze, set(int(c) for c in done), ss, qa)
            if ctl_admit:
                self._apply_admissions(ctl_admit, ss)
                admitted = tuple(int(g) for g, _ in ctl_admit)
                self._force_full = True
        self._plan_pending = [e for e in self._plan_pending if e[0] > ss]

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
            active_queries=qa,
            updated_pairs=updated_pairs,
            updated_per_query=upd_map,
            retired_queries=retired,
            admitted_queries=admitted,
            drained_queries=drained,
            vstate_faults=vs_faults,
            vstate_load_bytes=vs_load,
            vstate_spill_bytes=vs_spill,
            vstate_dirty_intervals=dirty_ivs,
        )
        self.history.append(stats)
        self.converged = (len(self.active_q) == 0 if multi_q
                          else len(all_idx) == 0)
        self._ss = ss + 1
        with self._lock:
            # in cluster mode every rank reads the backlog from the same
            # record; rank 0's queue may already hold a later admit()
            backlog = (bool(self._plan_pending) or ctl_pending > 0
                       or (eng.exchange is None
                           and bool(self._admit_queue)))
        self.finished = ((self.converged and not backlog)
                         or self._ss >= self.max_ss)
        return stats

    # -- result ----------------------------------------------------------------
    def result(self) -> RunResult:
        """The session's RunResult; the session must be finished.  Columns
        still live at ``max_supersteps`` are flushed into the result; the
        out-of-core store is materialized and closed."""
        if self._final_result is not None:
            return self._final_result
        if not self.finished:
            raise RuntimeError("session still live — step() to "
                               "completion or drain first")
        ooc, vstore = self._ooc, self.vstore
        values, aux_np = self.values, self.aux_np
        if self.multi_q:
            for c, gq in enumerate(self.active_q):
                self.final_values[:, int(gq)] = (
                    self.eng._ooc_column(vstore, c) if ooc
                    else values[:, c])
            values = self.final_values
        elif ooc:
            values = vstore.materialize("value")
        if ooc:
            # the working state and its spill tier are per-run scratch
            aux_np = {n: vstore.materialize(n) for n in vstore.names()
                      if n != "value"}
            vstore.close()
        self._final_result = RunResult(
            values=values, aux=aux_np, history=self.history,
            supersteps=len(self.history), converged=self.converged,
            per_query_supersteps=self.per_query_ss)
        return self._final_result

    # -- retirement and admission internals --------------------------------
    def _freeze(self, freeze: list, done: set, ss: int, qa: int) -> None:
        """Freeze the live columns ``freeze`` into ``final_values`` and
        compact them out of the values and the per-query ``[V, qa]`` aux,
        on the host, in the out-of-core store and on the device.  Columns
        in ``done`` converged at superstep ``ss``; the others drained."""
        keep = np.ones(qa, dtype=bool)
        keep[freeze] = False
        for c in freeze:
            gq = int(self.active_q[c])
            self.final_values[:, gq] = (
                self.eng._ooc_column(self.vstore, c) if self._ooc
                else self.values[:, c])
            if c in done:
                self.per_query_ss[gq] = ss + 1 - int(self.admitted_at[gq])
        if self._ooc:
            q_names = [n for n in self.vstore.names()
                       if self.vstore.spec(n)[1] == (qa,)]
            self.vstore.compact_columns(q_names, keep)
        else:
            self.values = np.ascontiguousarray(self.values[:, keep])
            for k, a in self.aux_np.items():
                if a.ndim == 2 and a.shape[1] == qa:  # per-query aux
                    self.aux_np[k] = np.ascontiguousarray(a[:, keep])
                    self.aux_dev[k] = self._to_device(self.aux_np[k])
        self.active_q = self.active_q[keep]

    def _collect_control(self, ss: int) -> Optional[dict]:
        """This barrier's admission/drain record, before its retirement is
        known: the drains asked for, the ``admit_plan`` entries due now
        (they bypass the slot cap) and, under ``queued``, the queued
        ``admit()`` seeds that could fill a slot (at most ``q_slots``),
        with the queue's length as ``pending``.  The classic engine and
        cluster rank 0 collect; :meth:`_settle_control` decides on every
        rank how many queued seeds fit."""
        if not self.multi_q:
            return None
        with self._lock:
            drains = list(dict.fromkeys(self._drain_queue))
            self._drain_queue.clear()
            admit: list[tuple[int, int]] = []
            for after, seeds in self._plan_pending:
                if after == ss:
                    for s in seeds:
                        admit.append((self.next_qid, int(s)))
                        self.next_qid += 1
            queued = self._admit_queue[: self.q_slots]
            record = comm.pack_admissions(admit, drains,
                                          len(self._admit_queue))
        if queued:
            record["queued"] = [[int(g), int(s)] for g, s in queued]
        return record

    def _settle_control(self, control: Optional[dict],
                        live: set) -> tuple[list, list, int]:
        """Resolve a barrier's record against its natural retirement
        (``live``: the columns that survive it), the same on every rank:
        drains of live columns free their slots, then queued seeds fill
        the free ones.  Returns (admissions, drains, seeds still queued);
        the admitted seeds leave the queue they were collected from (a
        cluster peer's queue is empty: ``admit()`` raises there)."""
        admit, drain, pending = comm.unpack_admissions(control)
        queued = [(int(g), int(s))
                  for g, s in (control or {}).get("queued", ())]
        live_drains = [g for g in drain if g in live]
        free = self.q_slots - (len(live) - len(live_drains))
        taken = queued[: max(0, free)]
        with self._lock:
            del self._admit_queue[: len(taken)]
        return admit + taken, drain, pending - len(taken)

    def _apply_admissions(self, admit: list, ss: int) -> None:
        """Splice freshly admitted query columns into the live state — the
        inverse of retirement's compaction.  A column's initial state comes
        from ``prog.with_queries(seeds).init`` (column math does not depend
        on the batch, so it equals a fresh single-query run bit for bit);
        per-query aux ``[V, q_new]`` splices alongside, shared aux is
        untouched, and the device copies of per-query aux are rebuilt."""
        eng = self.eng
        nv = self.nv
        gqs = [int(g) for g, _ in admit]
        seeds = [int(s) for _, s in admit]
        sub = self.prog.with_queries(seeds)
        state = sub.init(nv, eng.out_degree.astype(np.float64),
                         eng.in_degree.astype(np.float64))
        new_vals = np.asarray(state.pop("value")).astype(self.vdtype)
        qn = len(gqs)
        per_q_aux = {k: np.asarray(v) for k, v in state.items()
                     if np.asarray(v).ndim == 2
                     and np.asarray(v).shape[1] == qn}
        hi = max(gqs) + 1
        if hi > len(self.per_query_ss):
            grow = hi - len(self.per_query_ss)
            self.per_query_ss = np.concatenate(
                [self.per_query_ss, np.full(grow, -1, np.int64)])
            self.admitted_at = np.concatenate(
                [self.admitted_at, np.zeros(grow, np.int64)])
            self.final_values = np.ascontiguousarray(np.concatenate(
                [self.final_values,
                 np.zeros((nv, grow), self.final_values.dtype)], axis=1))
        for g, s in zip(gqs, seeds):
            self.admitted_at[g] = ss + 1
            self.query_seeds[g] = s
        self.final_values[:, gqs] = new_vals
        self.nq_total = len(self.per_query_ss)
        with self._lock:
            self.next_qid = max(self.next_qid, hi)
        if self._ooc:
            self.vstore.append_columns({"value": new_vals, **per_q_aux})
        else:
            self.values = np.ascontiguousarray(
                np.concatenate([self.values, new_vals], axis=1))
            for k, arr in per_q_aux.items():
                self.aux_np[k] = np.ascontiguousarray(
                    np.concatenate([self.aux_np[k], arr], axis=1))
                self.aux_dev[k] = self._to_device(self.aux_np[k])
        self.active_q = np.concatenate(
            [self.active_q, np.asarray(gqs, dtype=self.active_q.dtype)])
