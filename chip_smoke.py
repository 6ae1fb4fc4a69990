#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the three CUDA kernels from src/repro_torch/kernels/csrc, one
   nvcc each, started together.
3. Main-path store: SPE of an R-MAT graph (Graph500 a, b, c = 0.57, 0.19,
   0.19) at SCALE 22, edge factor 16 — 4,194,304 vertices, 67,108,864
   edges — in tiles of 2^20 edges, unweighted, disk mode 1.  The edges
   are drawn and the tiles built on up to 8 threads (synth.rmat_edges and
   spe.preprocess_arrays with ``threads``: the same edges and store bytes
   as one thread).
4. Kernels against their plain PyTorch versions on the card:
   - the row-length histogram (longest row; shares of rows with <= 1,
     <= 4, <= 32 edges) of the largest tile and of the merged dst list;
   - the segment kernel's order: its sum at the largest tile's shape,
     Q = 1 and Q = 8, equals bit for bit the fused kernel's with the
     identity apply (affine, alpha 0, beta 1, no base, num_rows = row_cap,
     so the sink row of padding edges is reduced too — through the hub
     launch when it holds two multiples of 256 edges);
   - the segment kernel at the largest tile's shapes (sum/min/max, Q in
     {1, 3, 4, 8}, sorted and unsorted dst, int32; a contrib view 4 bytes
     into its storage and ids out of range at both ends, -1 first and
     >= R last, at Q = 3 and 8) and once (sum) at the merged mode's shape
     (the server's 67,108,864 real edges, V + 1 rows);
   - ROADMAP C.1's reproducer: int32 min and max with contributions from
     randint(-1000, 1000) over a skewed list (2^17 rows of Zipf(1.8)
     lengths capped at 4,000, rows of 50,000, 9,000, 4,097, 3,000, 1,025,
     600 and 513 edges, 20,000 padding edges at dst = R; R + 1 rows) at
     every legal (block_e, block_r), each equal to the plain version, and
     timed at the default blocks; then the segment kernel's row and hub
     launches timed apart under torch.profiler for int32 sum, min and max
     at the largest tile (ROADMAP B.5);
   - the fused kernel at the largest tile's shapes and num_rows (the four
     single-query fused specs, PPR's spec with its per-query base, and a
     weighted spec with both edge streams; Q in {1, 4, 8}, and Q = 9 for
     the BFS spec, MultiSourceBFS after an admission), against the
     plain version and, bit for bit on new and updated, against the
     merged-mode composition: the program's gather in PyTorch, the
     segment kernel over rows [0, num_rows), the program's apply and
     updated_mask in PyTorch;
   - the same on a tile whose padding would be a hub row: the largest
     tile with num_rows cut so that its last PAD_HUB_EDGES real edges and
     the padding all point at num_rows (PageRank and BFS specs, Q = 1, 8);
   - the compact kernel at V = 4,194,304 with K = sparse_capacity(V)
     (densities 0, 1e-3, 0.05, 0.399; 0.6, where more than K are set and
     the first K are kept; int32 values; a fill index of 7; a mask view
     one byte into its storage), at V = 4,194,303, at V = 2^25, density
     0.01 (past the TPU kernel's 2^24 bound), with K = 0, and with K > V.
   Min, max, integers and compaction must be equal (compact: indices and
   value bits), sums within rtol=1e-5, atol=1e-6 (another order of
   summation); the fused kernel's updated mask must equal the plain
   version's (for sums, on every entry whose change is farther than that
   tolerance from update_tol) and leave rows past num_rows untouched.
   Each case is timed with CUDA events (L2 flushed before each launch,
   median of 10; the device spins ~0.5 ms before each call that does not
   synchronise with the host, so host enqueue time is not counted) beside
   the plain version (and, for the fused kernel, the merged-mode
   composition), one PyTorch call that computes
   the same function where there is one (scatter_reduce; for compact
   torch.nonzero plus a gather, which synchronises with the host, and
   also the whole function in PyTorch: torch.full of the K slots, then
   nonzero, truncation to K and the gather), and its bound (bytes over
   3.35 TB/s, flops over 67 TFLOP/s: roofline/hw.py's datasheet rates;
   the fused kernel's counts the real
   edges and base over num_rows rows only, the work its function needs).
5. Main path: OutOfCoreEngine(store, device="cuda", seg_impl="fused") runs
   PageRank for 5 supersteps (against a float64 power iteration,
   rtol=1e-4: float32 against float64), BFS from vertex 0 to convergence
   (equal to a level-synchronous BFS) and InDegree for 1 superstep
   (equal to np.bincount).  The PageRank, BFS and PPR references of
   phases 5, 8, 12, 16 and 18 are plain PyTorch over the edge list on the
   card (ref_pagerank, ref_bfs, ref_ppr: gathers and index_add_, no code
   of the port), in place of numpy and scipy on the host.
6. Compact path: ops.compact over the sparse broadcast of each BFS
   superstep of phase 5 (the vertices it updated, their levels),
   K = sparse_capacity(V); equal to numpy's nonzero.
7. One PageRank superstep under torch.profiler: device busy share and the
   kernels' device time.  Phases 7, 8 and 10, PageRank in 11 and the
   reference and out-of-core runs of 12 run with tile skipping off: on
   R-MAT it skips no tile and never changes a result, and its filter
   build is most of a superstep 0 (8-21 s).
8. Batched apps at Q = 8 on the same store, seg_impl="fused", tile
   skipping off (phase 12's in-memory session runs it on): sources are
   vertex 0 and seven vertices drawn with numpy from SEED among those with
   out-degree > 0.  MultiSourceBFS to convergence (each column equal to
   the reference BFS from its source, column 0 equal to phase 5's BFS);
   LandmarkDistances on the unweighted store (edge weight 1.0, the b
   stream), equal to MultiSourceBFS with equal per-query supersteps;
   PersonalizedPageRank for 3 supersteps against a float64
   power iteration with the same update gate (|new - old| > update_tol):
   relative error <= 1e-4 on entries >= 1e-6 and L1 error <= 1e-5 per
   column.  An entry whose change in some superstep lies within float32
   rounding of update_tol takes it in one iteration and not the other,
   and differs by about update_tol (1e-9, which is 1e-3 of a 1e-6 entry):
   such gate flips may exceed the relative limit, each by at most
   update_tol per superstep, in at most 1e-4 of the entries.  Column 0
   equal bit for bit to a Q = 1 PPR run.
9. Modes: PageRank (5 supersteps) and MultiSourceBFS (Q = 8, to
   convergence, so retirement shrinks Q from 8 to 1) with engine_mode
   "stacked", "merged" and pipeline=True, tile skipping off so every
   superstep runs in the mode; each equal bit for bit to the tiled runs
   of phases 5 and 8, per-query supersteps too (tile skipping never
   changes a result).
10. One MultiSourceBFS superstep at Q = 8 under torch.profiler.
11. Out-of-core vertex state ("ooc") on the same store, with
    num_intervals = OOC_INTERVALS: the engine cuts the vertices into
    intervals aligned to tiles and computes each tile's source footprint
    as it loads the tile (timed once over all tiles); PageRank for
    OOC_PR_SUPERSTEPS = 2 supersteps (cut from 5, then 3, to keep the run
    inside its time limit) under an 8 MiB vertex budget (superstep 1 profiled:
    H2D bytes of the sharded step, copy and kernel device time, the host
    gather and writeback) and InDegree for 1 under 8 MiB; each equal bit
    for bit to the in-memory tiled run of as many supersteps, with 64
    kernel calls a superstep, faults, spills and dirty intervals (the
    budget binds), and its ms a superstep beside the tiled run's.
    MultiSourceBFS at Q = 8 under 32 MiB is the first two supersteps of
    phase 12's out-of-core session.
12. Mid-run admission ("admission"): a MultiSourceBFS session at Q = 8
    whose admit_plan brings a ninth source in after superstep 1 (Q = 9
    at superstep 2, 64 fused calls; the ninth source is drawn among
    vertices whose out-neighbours are all sinks, so its column retires
    after its second superstep), query 1 drained after superstep 2 and a
    tenth source admitted through admit() once a column has left; to
    convergence in memory, each admitted column equal to a fresh
    single-query run with equal per-query supersteps, the drained one
    to the reference BFS levels up to 3 with -1, the other originals to phase
    8's Q = 8 run; its first ADMIT_OOC_SUPERSTEPS = 2 supersteps (Q = 8,
    8 and the ninth query's admission at the barrier of superstep 1; cut
    from 3, whose Q = 9 superstep took 78-103 s: the Q = 9
    superstep, the drain, the ninth query's retirement and the tenth's
    admission are checked in memory here) in memory and
    under a 32 MiB budget equal bit for bit,
    the latter with 64 fused calls a superstep and its budget binding.
    Device bytes outside torch's allocator (the CUDA context and the
    kernels' code; the hub launch's scratch is taken from torch's
    allocator by the wrappers) are logged around each superstep and each
    phase 4 fused case, and must not grow at phase 4's first Q = 9 call.
13. Device mesh ("mesh"): DistributedGABEngine over a process group of
    world size 1 on NCCL, all 64 tiles resident on the card: PageRank
    for 5 supersteps in dense, sparse and hybrid comm (in sparse, the
    overflow guard sends every superstep past the capacity dense,
    superstep 0 among them) and MultiSourceBFS at Q = 8 in hybrid to
    convergence (its late supersteps take the sparse branch: the
    compact kernel over the 2^25-cell mask, an all_gather, an index
    put), each equal bit for bit to the tiled run of phases 5 and 8;
    then world size 2 on gloo with CUDA tensors, two spawned ranks on the
    one card: a sparse collective on 2^20 cells equal to the merge, and
    PageRank in hybrid equal to the tiled run (if this torch's gloo
    refuses CUDA tensors, a line says so and the run goes on).
14. Cluster ("cluster"): launch.cluster.run_cluster on the card at N = 2
    and N = 4 (spawned ranks sharing the one card, shm transport,
    hybrid frames, tile skipping off), one launch per N over PageRank
    and MultiSourceBFS at Q = 8 whose admit_plan brings phase 12's ninth
    source in after superstep 1, both for 5 supersteps: every rank's
    values, supersteps, per-query supersteps and (admitted, retired,
    updated) per superstep equal one process bit for bit, wire bytes
    equal across ranks.  Each rank reports its seconds, kernel
    launches, torch memory and the card's bytes in use, and the
    exchange's seconds (encode and compress, send, wait for peers,
    decode, merge) per app.
15. Checkpoints ("checkpoint"), each part against its uninterrupted run
    bit for bit, with every boundary checkpointed (each save's seconds,
    bytes written and hardlinked, interval blocks written and
    hardlinked, and each load's seconds logged): (a) tiled PageRank
    crashed (InjectedFault) at the start of superstep 3 and resumed by a
    fresh engine to 5 supersteps, equal to phase 5's run, its history
    the resumed supersteps only; (b) MultiSourceBFS at Q = 8 with phase
    12's ninth source admitted after superstep 1, preemptible, SIGTERM
    at the barrier of superstep 2 (Preempted at boundary 3), resumed to
    5 supersteps, equal to phase 14's one-process run (values and
    per-query supersteps); (c) out-of-core PageRank at 8 MiB, 3
    supersteps (cut from 5: each is ~21 s), crashed at superstep 2, its
    checkpoints interval blocks (the codec sniffed: zlib without
    zstandard), the second hardlinking the unchanged ones, equal to the
    in-memory run of 3 supersteps; (d) run_cluster on the card, N = 4
    spawned ranks, PageRank for 5 supersteps, rank 3 killed (os._exit)
    at the barrier of superstep 2, on_failure="shrink": one restart on
    3 ranks on the remapped saved assignment, rank 0 equal to phase 5's
    run, the ranks to each other; the kill (its once-marker's time) to
    the new attempt's first boundary checkpoint is logged.
16. Online query service ("serve"): serve/graph_service.py's
    GraphService on the card (device cuda, seg_impl "fused", tile
    skipping off, q_slots 8, min_fill 4, max_wait 50 ms, tenants alice:3
    and bob:1, a result cache of 64) behind serve/http.py's HttpFrontend
    on 127.0.0.1:0, the serve loop on its own thread; client threads POST
    and poll GET /v1/query/<rid>.  Wave 1: MultiSourceBFS from phase 8's
    eight sources and LandmarkDistances from two new seeds drawn from
    SEED; wave 2: LandmarkDistances from two more and MultiSourceBFS from
    the unused vertex of largest out-degree with a 1 ms deadline; wave 3:
    repeats of three finished seeds.  Every done column (decoded from its
    HTTP body) equals the reference BFS levels with the per-query supersteps of
    its depth, the sources' equal phase 8's direct batched run bit for bit
    with equal per-query supersteps; the deadline query ends "timeout"
    with a partial BFS column that is not cached; the repeats are cache
    hits that open no session, run no superstep and take no slot.  Then
    the drain: /healthz and POST answer 503 with Retry-After, every rid
    still answers GET.  Logged: p50/p99 latency, the mean queue and
    service ms, queries/s, supersteps, sessions, the (program, Q) of every
    fused launch, and torch's allocated and reserved bytes and the bytes
    outside torch's allocator after each closed session; the fused kernel
    is held to its plain version and the merged-mode composition at every
    (program, Q) the service launched it at.

17. Kernel tuner ("tune"): (a) roofline/hw.py's measured figures
    measured again and logged beside the table's (calibrate_tuner);
    (b) at the largest tile's shape, the fused kernel with the PageRank
    spec at Q = 1 and 8, the BFS spec at Q = 1, 8 and 9 and the
    landmarks spec at Q = 2 and 8, and the segment sum at Q = 1 and 8,
    each at every legal (block_e, block_r): new and updated (out) equal
    to the default blocks' bit for bit, each timed as phase 4 times,
    beside roofline/kernel_tune.py's prediction, and the pick's time
    over the best measured time; (c) EngineConfig(kernel_autotune=True):
    tiled PageRank for 5 supersteps equal to phase 5's run,
    MultiSourceBFS Q = 8 tiled and pipelined (the tuner's stack size) to
    convergence equal to phase 8's run, bit for bit, each launching the
    fused kernel.
18. Baselines ("baselines"): core/baselines.py's four engines (Pregel+,
    PowerGraph, GraphD, Chaos) on the main store's graph on the card,
    PageRank for 2 supersteps each, against a float64 power iteration
    (rtol=1e-4); ms a superstep beside the tiled engine's (phase 5).
19. Language-model serving ("lm serve"), float32, parameters from the
    port's seeded LM.init, TF32 off: (a) qwen3-1.7b at full width (28
    layers, d_model 2,048, padded vocab 152,064) through
    launch/serve.py:main at the CLI's defaults (16 requests, 4 slots, 16
    new tokens, prompts of 16, max length 256): every completion has 16
    tokens, requests 0 and 5 served alone in a 1-slot engine give the
    same greedy tokens, and decode_step's logits for a 24-token sequence
    (23 prefilled) match the full forward's last within LM_LOGITS_ATOL;
    (b) gemma2-2b at full width (26 layers LG, window 4,096, vocab
    256,000): one prompt of 4,160 tokens prefilled at q_chunk = kv_chunk
    = 512, then 8 greedy decode steps; the prefill's and every decode
    step's logits match the full forward over the prompt and the decoded
    tokens within LM_LOGITS_ATOL, so the rolling window cache is held at
    full width; (c) logged: prefill ms, ms a decode step, tokens/s, the
    card's bytes in use and torch's peak.  This path runs no kernel of the
    graph engine: its counts are read and logged as zero.

Phase 11, the out-of-core part of 12 ("admission ooc", admission_ooc)
and part c of 15 (checkpoint_ooc) run in three spawned side processes
(Side), started after phase 7 and joined after phase 10: each is host
work that leaves the card idle, so they run on other cores beside phases
8-10, whose times (and theirs) are taken with the others running.  A
side's kernels count in its process and report; its lines are logged
when it is joined.

Phases 5, 6, 8, 9, 11, 13, 14, 16, 17c and 19, the in-memory session of
12 and its out-of-core session ("admission ooc") and each part of 15
("checkpoint" sums a and b, then "checkpoint ooc", "cluster restart") set
every kernel's launch counter to 0 just before and read it just after
(the cluster ranks and phase 13's gloo ranks count in their processes
and report); each must have launched the kernels it runs.  The
``{"kernels": [...]}`` line gives, per kernel and case, the launches
summed over those phases, the launches by phase ("launches_by_path") and
the case's times: segment sum at the largest tile for Q = 1 and Q = 8 and
at the merged shape, int32 min and max on C.1's skewed list, the fused
PageRank spec at Q = 1 and Q = 8, BFS spec
at Q = 9 and the serve path's most launched (program, Q) (with
"composition_ms"), compact at V = 4,194,304, density 0.05 and at V = 2^25
(the "case" key names it), and each phase 17 case at its tuned blocks.
Then, as its last line,
``{"ok": true, "device": {...}}``.  Any failed check raises; without a CUDA
device, or without the repository beside it, it exits non-zero before
printing a result.  Details go to build/chip_smoke.json.  Each phase's
end also goes to stderr with the seconds so far, and a run still going
after WATCHDOG_S seconds prints every thread's stack there.
"""
import faulthandler
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SCALE = 22
EDGE_FACTOR = 16
TILE_SIZE = 1 << 20
SEED = 0
PR_SUPERSTEPS = 5
PPR_SUPERSTEPS = 3           # cut from 5 in PR 16 to make room for 11-12
BFS_MAX_SUPERSTEPS = 40
NUM_QUERIES = 8
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
SPIN_CYCLES = 1_000_000      # ~0.5 ms of device clock before each timed call
PR_RTOL = 1e-4
PPR_MIN_ENTRY = 1e-6
PPR_L1 = 1e-5
PPR_MAX_FLIP_SHARE = 1e-4
PAD_HUB_EDGES = 20000        # real edges turned into padding (phase 4)
SKEWED_ROWS = 1 << 17        # ROADMAP C.1's skewed int32 list (phase 4)
OOC_INTERVALS = 16           # interval plan of the out-of-core runs
OOC_PR_BUDGET = 8 << 20      # PageRank / InDegree vertex budget, bytes
OOC_PR_SUPERSTEPS = 2        # out-of-core PageRank (each ~20-27 s)
OOC_MSBFS_BUDGET = 32 << 20  # MultiSourceBFS (Q = 8 and 9) vertex budget
DRAIN_AT = 2                 # admission: drain query DRAIN_QID after this
DRAIN_QID = 1                # superstep
BASELINE_SUPERSTEPS = 2      # each baseline engine's PageRank (phase 18)
LM_SERVE_ARCH = "qwen3-1.7b"  # phase 19 (a): through the serve CLI
LM_SINGLE_RIDS = (0, 5)      # requests rerun alone in a 1-slot engine
LM_WINDOW_ARCH = "gemma2-2b"  # phase 19 (b): a prompt past the window
LM_WINDOW_PROMPT = 4160
LM_WINDOW_DECODE = 8
LM_WINDOW_CHUNK = 512        # q_chunk = kv_chunk of (b)
LM_LOGITS_ATOL = 2e-3        # decode vs full-forward logits, float32
ADMIT_OOC_SUPERSTEPS = 2     # admission session compared out of core (cut
                             # from 3: its Q = 9 superstep took 78-103 s)
CKPT_CRASH_SS = 3            # checkpoint: crash at the start of superstep 3
CKPT_PREEMPT_SS = 2          # SIGTERM at the barrier of superstep 2
OOC_CKPT_SUPERSTEPS = 3      # out-of-core checkpoint run: cut from 5
OOC_CKPT_CRASH_SS = 2
SHRINK_FROM = 4              # cluster restart: N = 4 ...
SHRINK_KILL = (2, 3)         # ... rank 3 killed at the barrier of superstep 2
SERVE_Q_SLOTS = 8            # serve: live query columns a session
SERVE_MIN_FILL = 4           # batch admissions until 4 are queued ...
SERVE_MAX_WAIT_S = 0.05      # ... or the oldest waited this long
SERVE_TENANTS = {"alice": 3.0, "bob": 1.0}
SERVE_CACHE = 64             # result-cache entries
SERVE_LANDMARKS = 4          # new LandmarkDistances seeds (waves 1 and 2)
SERVE_DEADLINE_MS = 1.0      # the deadline query's deadline
SERVE_POLL_S = 0.2           # a client's GET interval
SERVE_CLIENT_TIMEOUT_S = 600
DEV = "cuda"
WATCHDOG_S = 1100            # stacks to stderr if the run is still going


def log(msg):
    print(msg, flush=True)


def card_info(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    from repro_torch import compat

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"codec {'zstandard' if compat.HAVE_ZSTD else 'zlib (no zstandard)'}")
    return smi


def time_ms(torch, fn, flush, reps=10, spin=True):
    """Median device time of one call, CUDA events around each call, the L2
    cache flushed before each (the main path finds a tile cold).  A spin on
    the device after the flush keeps it busy until the host has queued the
    call, so the events time the device's work, not the host's enqueue;
    ``spin=False`` for a call that synchronises with the host inside (a
    head start would only add the host thread's wake-up to its time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops):
    """The least ms for nbytes and flops on the card (roofline/hw.py's
    datasheet HBM and FP32 rates) and which of the two binds."""
    from repro_torch.roofline import hw

    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / hw.F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want):
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())


def check_equal_or_close(torch, got, want, exact, what):
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from plain version")
    else:
        torch.testing.assert_close(got, want, **SUM_TOL, msg=what)


def kernel_modules():
    from repro_torch.kernels import compact, gab_fused, gab_gather
    return {"segment_reduce": gab_gather, "gab_fused": gab_fused,
            "compact": compact}


def reset_launches():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches():
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


def require_launches(launches, names, what):
    log(f"{what} launches: {launches}")
    missing = [n for n in names if not launches[n]]
    if missing:
        raise AssertionError(f"{what}: {missing} not launched: {launches}")


def build_store(root):
    from repro_torch.graphio import spe, synth
    from repro_torch.graphio.formats import TileStore

    nv, ne = 1 << SCALE, EDGE_FACTOR << SCALE
    t0 = time.perf_counter()
    threads = min(8, os.cpu_count() or 1)
    chunks = list(synth.rmat_edges(nv, ne, seed=SEED, threads=threads))
    src = np.concatenate([c[0] for c in chunks])
    dst = np.concatenate([c[1] for c in chunks])
    t_gen = time.perf_counter() - t0
    store = TileStore(root, disk_mode=1)
    t0 = time.perf_counter()
    plan = spe.preprocess_arrays(src, dst, None, nv, store,
                                 tile_size=TILE_SIZE, threads=threads)
    t_spe = time.perf_counter() - t0
    log(f"store: SCALE {SCALE}, {nv} vertices, {ne} edges, "
        f"{plan.num_tiles} tiles, edge_cap {plan.edge_cap}, row_cap "
        f"{plan.row_cap}; R-MAT {t_gen:.1f} s, SPE {t_spe:.1f} s "
        f"({threads} threads)")
    return store, plan, src, dst, dict(generate_s=t_gen, spe_s=t_spe,
                                       num_tiles=plan.num_tiles,
                                       edge_cap=plan.edge_cap,
                                       row_cap=plan.row_cap)


def segment_row(torch, flush, c, d, r, combine, what, reps=10):
    """Time the segment kernel, its plain version and scatter_reduce on
    contrib c [E(, Q)] and ascending dst d [E] into r rows."""
    from repro_torch.kernels import gab_gather, ref

    e = d.shape[0]
    q = 1 if c.ndim == 1 else c.shape[1]
    idx = d.long()
    if q > 1:
        idx = idx[:, None].expand(e, q).contiguous()
    init = torch.full((r,) + tuple(c.shape[1:]),
                      ref.identity(combine, c.dtype), dtype=c.dtype,
                      device=c.device)
    lib_reduce = {"sum": "sum", "min": "amin", "max": "amax"}[combine]
    nbytes = e * 4 + e * 4 * q + r * 4 * q
    b_ms, b_by = bound(nbytes, e * q)
    row = dict(
        combine=combine, q=q, edges=e, rows=r,
        kernel_ms=time_ms(torch, lambda: gab_gather.segment_reduce(
            c, d, r, combine), flush, reps),
        plain_ms=time_ms(torch, lambda: ref.segment_reduce(
            c, d, r, combine), flush, reps),
        library_ms=time_ms(torch, lambda: torch.scatter_reduce(
            init, 0, idx, c, lib_reduce), flush, reps),
        bound_ms=b_ms, bound_by=b_by)
    log(f"{what}: kernel {row['kernel_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, scatter_reduce {row['library_ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by})")
    return row


def row_lengths(dst, num_rows, what):
    """Log the row-length histogram of an ascending dst list: the longest
    row and the shares of rows with <= 1, <= 4 and <= 32 edges."""
    d = np.asarray(dst)
    counts = np.bincount(d[(d >= 0) & (d < num_rows)], minlength=num_rows)
    out = dict(rows=int(num_rows), max=int(counts.max()),
               **{f"le_{k}": float((counts <= k).mean()) for k in (1, 4, 32)})
    log(f"{what} row lengths: max {out['max']}, <= 1 edge "
        f"{out['le_1']:.4f}, <= 4 {out['le_4']:.4f}, <= 32 "
        f"{out['le_32']:.4f} of {num_rows} rows")
    return out


def check_segment_order(torch, tile, plan):
    """The segment kernel's sum is the fused kernel's order, bit for bit:
    at the largest tile's shape, Q = 1 and Q = 8, segment sum into row_cap
    rows against gab_fused with the identity apply (affine, alpha 0, beta
    1, no base, no edge streams, num_rows = row_cap: new = 0 + 1 · acc)."""
    from repro_torch.kernels import gab_fused, gab_gather
    from repro_torch.kernels.gab_fused import FusedSpec

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    e, r = plan.edge_cap, plan.row_cap
    d = torch.from_numpy(tile.dst_local).to(dev)
    spec = FusedSpec(combine="sum", apply="affine", alpha=0.0, beta=1.0)
    for q in (1, NUM_QUERIES):
        tail = () if q == 1 else (q,)
        c = torch.rand((e,) + tail, generator=gen, device=dev)
        seg = gab_gather.segment_reduce(c, d, r, "sum")
        new, _ = gab_fused.gab_fused(spec, c, None, None, d,
                                     torch.zeros((r,) + tail, device=dev),
                                     None, r, r)
        if not torch.equal(seg, new):
            raise AssertionError(f"segment sum Q={q} differs from gab_fused's "
                                 f"order in {int((seg != new).sum())} entries")
    log("segment sum equals gab_fused's identity apply bit for bit at Q = 1 "
        f"and Q = {NUM_QUERIES}")


def check_segment_kernel(torch, tile, plan, flush):
    """Segment kernel against ref.segment_reduce at the tiles' shapes
    (InDegree, the segment backend: contrib [edge_cap(, Q)],
    num_segments row_cap + 1)."""
    from repro_torch.kernels import gab_gather, ref

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, r = plan.edge_cap, plan.row_cap + 1
    dst_sorted = torch.from_numpy(tile.dst_local).to(dev)
    perm = torch.randperm(e, generator=gen, device=dev)
    rows = []
    err = 0.0
    for combine in ("sum", "min", "max"):
        for q in (1, 3, 4, NUM_QUERIES):
            shape = (e,) if q == 1 else (e, q)
            # positive messages for sums (as PageRank's): no cancellation
            c = (torch.rand(shape, generator=gen, device=dev)
                 if combine == "sum"
                 else torch.randn(shape, generator=gen, device=dev))
            for sorted_ids in (True, False):
                d = dst_sorted if sorted_ids else dst_sorted[perm].contiguous()
                got = gab_gather.segment_reduce(c, d, r, combine, sorted_ids)
                want = ref.segment_reduce(c, d, r, combine, sorted_ids)
                check_equal_or_close(torch, got, want, combine != "sum",
                                     f"segment {combine} Q={q} "
                                     f"sorted={sorted_ids}")
                err = max(err, max_abs_err(torch, got, want))
            rows.append(segment_row(torch, flush, c, dst_sorted, r, combine,
                                    f"segment {combine} Q={q}"))
    ci = torch.randint(-(1 << 30), 1 << 30, (e,), generator=gen, device=dev,
                       dtype=torch.int32)
    for combine in ("sum", "min", "max"):
        got = gab_gather.segment_reduce(ci, dst_sorted, r, combine)
        want = ref.segment_reduce(ci, dst_sorted, r, combine)
        check_equal_or_close(torch, got, want, True, f"segment int32 {combine}")
    # a contrib view 4 bytes into its storage (no 16-byte alignment), Q = 3
    # and Q = 8; ids out of range at both ends (-1 first, >= R last)
    d_out = torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev),
                       dst_sorted,
                       torch.tensor([r, r + 5], dtype=torch.int32,
                                    device=dev)])
    for q in (3, NUM_QUERIES):
        flat = torch.rand((e + 3) * q + 1, generator=gen, device=dev)
        view = flat[1:1 + e * q].view(e, q)
        out_ids = flat[1:1 + (e + 3) * q].view(e + 3, q)
        for combine in ("sum", "min", "max"):
            for c, d, name in ((view, dst_sorted, "offset view"),
                               (out_ids, d_out, "ids out of range")):
                got = gab_gather.segment_reduce(c, d, r, combine)
                want = ref.segment_reduce(c, d, r, combine)
                check_equal_or_close(torch, got, want, combine != "sum",
                                     f"segment {combine} Q={q} {name}")
                err = max(err, max_abs_err(torch, got, want))
    log(f"segment kernel: all cases agree, max |err| {err:.3g}")
    return rows, err


def skewed_int32_list(rows, seed=SEED):
    """ROADMAP C.1's list (tests/test_torch_kernel_order.py builds the same
    at fewer rows): ``rows`` rows of Zipf(1.8) lengths capped at 4,000,
    rows of 50,000, 9,000, 4,097, 3,000, 1,025, 600 and 513 edges at rows
    k·rows/8 (k = 1..7), 20,000 padding edges at dst = rows, int32
    contributions from randint(-1000, 1000); rows + 1 output rows."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(1.8, rows), 4000)
    for k, n in enumerate((50000, 9000, 4097, 3000, 1025, 600, 513)):
        lengths[(k + 1) * (rows // 8)] = n
    dst = np.concatenate([np.repeat(np.arange(rows), lengths),
                          np.full(20000, rows)]).astype(np.int32)
    contrib = rng.integers(-1000, 1000, dst.shape[0]).astype(np.int32)
    return dst, contrib, rows + 1


def check_segment_skewed_int32(torch, flush):
    """ROADMAP C.1's reproducer: int32 min and max with negative
    contributions over the skewed list, at every legal (block_e,
    block_r), each torch.equal to the plain version; timed at the default
    blocks."""
    from repro_torch.kernels import blocks, gab_gather, ref

    dev = torch.device(DEV)
    d_np, c_np, r = skewed_int32_list(SKEWED_ROWS)
    lengths = row_lengths(d_np, r, "C.1 skewed list")
    d = torch.from_numpy(d_np).to(dev)
    c = torch.from_numpy(c_np).to(dev)
    rows = []
    for combine in ("min", "max"):
        want = ref.segment_reduce(c, d, r, combine)
        for pair in ((be, br) for be in blocks.BLOCK_E
                     for br in blocks.BLOCK_R):
            got = gab_gather.segment_reduce(c, d, r, combine, blocks=pair)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"C.1 skewed int32 {combine} at blocks {pair}: "
                    f"{int((got != want).sum())} rows differ from the plain "
                    "version")
        row = segment_row(torch, flush, c, d, r, combine,
                          f"C.1 skewed int32 {combine} E={d.shape[0]} R={r}")
        row.update(shape="skewed int32", row_lengths=lengths,
                   pairs=len(blocks.BLOCK_E) * len(blocks.BLOCK_R))
        rows.append(row)
    log(f"C.1 skewed list: int32 min and max equal to the plain version at "
        f"all {rows[0]['pairs']} block pairs")
    return rows


def row_hub_ms(torch, fn, calls=10):
    """Device ms a call of the GAB kernels' row and hub launches in
    ``fn()``, from torch.profiler (the mean of ``calls`` calls, L2 not
    flushed)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ms = {"row": 0.0, "hub": 0.0}
    for ev in prof.key_averages():
        for kind in ms:
            if ev.device_type == cuda and f"{kind}_kernel" in ev.key:
                ms[kind] += ev.device_time_total / 1e3 / calls
    return ms


def segment_int32_launches(torch, tile, plan):
    """B.5: the segment kernel's row and hub launches for int32 sum, min
    and max at the largest tile (``row_hub_ms``)."""
    from repro_torch.kernels import gab_gather

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    e, r = plan.edge_cap, plan.row_cap + 1
    d = torch.from_numpy(tile.dst_local).to(dev)
    ci = torch.randint(-(1 << 30), 1 << 30, (e,), generator=gen, device=dev,
                       dtype=torch.int32)
    out = {combine: row_hub_ms(torch, lambda c=combine:
                               gab_gather.segment_reduce(ci, d, r, c))
           for combine in ("sum", "min", "max")}
    log("B.5, int32 at the largest tile, device ms a call: " + "; ".join(
        f"{c} row {m['row']:.4f} hub {m['hub']:.4f}"
        for c, m in out.items()))
    return out


def check_merged_segment(torch, dst, nv, flush):
    """Segment kernel (sum) at the merged mode's shape: the server's real
    edges by ascending global dst into V + 1 rows."""
    from repro_torch.kernels import gab_gather, ref

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    d_np = np.sort(dst).astype(np.int32)
    lengths = row_lengths(d_np, nv + 1, "merged dst list")
    d = torch.from_numpy(d_np).to(dev)
    del d_np
    c = torch.rand(d.shape[0], generator=gen, device=dev)
    got = gab_gather.segment_reduce(c, d, nv + 1, "sum")
    want = ref.segment_reduce(c, d, nv + 1, "sum")
    check_equal_or_close(torch, got, want, False, "segment sum merged shape")
    err = max_abs_err(torch, got, want)
    row = segment_row(torch, flush, c, d, nv + 1, "sum",
                      f"segment sum merged shape E={d.shape[0]} R={nv + 1}",
                      reps=5)
    row["shape"] = "merged"
    row["row_lengths"] = lengths
    log(f"segment kernel at the merged shape agrees, max |err| {err:.3g}")
    return row, err


def check_fused_mask(torch, spec, new, upd, pnew, pupd, old, nr, what):
    """The fused kernel's updated mask: rows at or past num_rows keep old and
    are not updated; below, the mask is the spec's test on the kernel's own
    new values, and equals the plain version's wherever the two versions'
    sums (which differ in their order of summation) cannot fall on opposite
    sides of update_tol."""
    if bool(upd[nr:].any()) or not torch.equal(new[nr:], old[nr:]):
        raise AssertionError(f"{what}: a row past num_rows changed")
    diff = (new[:nr] - old[:nr]).abs()
    own = diff > spec.update_tol if spec.update_tol > 0.0 else diff != 0
    if not torch.equal(upd[:nr], own):
        raise AssertionError(f"{what}: updated mask is not the spec's test")
    if spec.combine == "sum":
        margin = SUM_TOL["atol"] + SUM_TOL["rtol"] * pnew.abs()
        clear = ((pnew - old).abs() - spec.update_tol).abs() > margin
    else:
        clear = torch.ones_like(upd)
    if not torch.equal(upd[clear], pupd[clear]):
        raise AssertionError(f"{what}: updated mask differs")
    return int(clear.sum()), upd.numel()


def fused_cases():
    """The programs whose fused specs phase 4 runs: the five apps with a
    FusedSpec, and PageRank whose messages also add the edge's value (the
    one case with both edge streams, a and b)."""
    import dataclasses

    from repro_torch.core import apps

    @dataclasses.dataclass(eq=False)
    class WeightedRank(apps.PageRank):
        def gather(self, src_value, edge_val, aux):
            return super().gather(src_value, edge_val, aux) + edge_val

        def fused_spec(self):
            return dataclasses.replace(super().fused_spec(), add_edge=True)

    return {
        "pagerank": apps.PageRank(),
        "sssp": apps.SSSP(),
        "wcc": apps.WCC(),
        "bfs": apps.BFS(),
        "ppr": apps.PersonalizedPageRank(),
        "weighted": WeightedRank(),
    }


def batched(prog):
    """Whether prog is a batched program (values [V, Q] at every Q)."""
    return hasattr(prog, "with_queries")


def fused_inputs(torch, prog, dst, nr, r, q, gen):
    """Inputs of one fused case at a tile's shape, as the engine forms
    them: src [E(, Q)] (2-D for a batched program; 30 % inf for min
    specs: unreached sources), old and base [r(, Q)], the edge values ev
    (0 on padding edges, dst >= nr) and the gathered source aux inv, and
    the kernel's streams a = inv · ev, b = ev.  Returns (kernel args,
    (prog, ev, inv))."""
    spec = prog.fused_spec()
    dev = dst.device
    e = dst.shape[0]
    tail = (q,) if q > 1 or batched(prog) else ()
    ev = torch.where(dst < nr, torch.rand(e, generator=gen, device=dev) + 0.5,
                     torch.zeros((), device=dev))
    inv = torch.rand(e, generator=gen, device=dev)
    src = torch.rand((e,) + tail, generator=gen, device=dev) * 5
    if spec.combine == "min":
        src = torch.where(torch.rand(src.shape, generator=gen,
                                     device=dev) < 0.3,
                          torch.full_like(src, float("inf")), src)
    old = torch.rand((r,) + tail, generator=gen, device=dev) * 5
    a = (inv * ev) if spec.scale_aux else None
    b = ev if spec.add_edge else None
    base = (torch.rand((r,) + tail, generator=gen, device=dev)
            if spec.base_aux else None)
    return (spec, src, a, b, dst, old, base, nr, r), (prog, ev, inv)


def merged_composition(torch, prog, ev, inv, args):
    """The engine's merged mode at a tile's shape (gab.merged_server_step):
    the program's gather in PyTorch, the segment kernel over rows [0,
    num_rows), the program's apply and updated_mask; rows past num_rows
    keep old.  Every product and sum is its own PyTorch operation, so it
    rounds as the fused kernel's, and the segment kernel sums each row in
    the fused kernel's order: the two must agree bit for bit.  A
    single-query program at Q > 1 gets its edge arrays as [E, 1] columns,
    so that its message broadcasts over the query columns as the fused
    kernel's does."""
    from repro_torch.kernels import gab_gather

    spec, src, _, _, dst, old, base, nr, _ = args
    if src.ndim == 2 and not batched(prog):
        ev, inv = ev[:, None], inv[:, None]
    contrib = prog.gather(src, ev, {k: inv for k in prog.src_aux})
    acc = gab_gather.segment_reduce(contrib, dst, nr, prog.combine)
    o = old[:nr]
    new = prog.apply(o, acc, {k: base[:nr] for k in prog.dst_aux})
    upd = prog.updated_mask(o, new)
    return (torch.cat([new, old[nr:]]),
            torch.cat([upd, torch.zeros(old[nr:].shape, dtype=torch.bool,
                                        device=old.device)]))


def fused_bound(args):
    """The fused function's least bytes and operations: src, dst and each
    edge stream over the real edges (padding edges, dst >= num_rows, are
    never reduced), old, new and updated over row_cap rows, base over
    num_rows rows; a message step an edge stream, the apply over num_rows
    rows."""
    spec, src, a, b, dst, old, base, nr, r = args
    e = int((dst < nr).sum())
    q = 1 if src.ndim == 1 else src.shape[1]
    streams = int(a is not None) + int(b is not None)
    nbytes = (e * (4 + 4 * q + 4 * streams) + r * q * (4 + 4 + 1)
              + nr * q * 4 * int(base is not None))
    flops = e * q * (1 + streams + int(spec.add_const is not None))
    return bound(nbytes, flops + 3 * nr * q)


def check_fused_case(torch, case, flush, what):
    """One fused case: the kernel against the plain version (sums within
    SUM_TOL, the rest equal; the mask as check_fused_mask says) and bit
    for bit against the merged-mode composition, then each timed."""
    from repro_torch.kernels import gab_fused, ref

    args, (prog, ev, inv) = case
    spec, src, _, _, _, old, _, nr, _ = args
    new, upd = gab_fused.gab_fused(*args)
    pnew, pupd = ref.gab_fused_ref(*args)
    cnew, cupd = merged_composition(torch, prog, ev, inv, args)
    check_equal_or_close(torch, new, pnew, spec.combine != "sum", what)
    n_clear, n_rows = check_fused_mask(torch, spec, new, upd, pnew, pupd,
                                       old, nr, what)
    if not (torch.equal(new, cnew) and torch.equal(upd, cupd)):
        raise AssertionError(
            f"{what}: differs from the merged-mode composition in "
            f"{int((new != cnew).sum())} values, "
            f"{int((upd != cupd).sum())} mask entries")
    q = 1 if src.ndim == 1 else src.shape[1]
    b_ms, b_by = fused_bound(args)
    row = dict(q=q, num_rows=int(nr), library_ms=None, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=max_abs_err(torch, new, pnew),
               mask_clear=n_clear, mask_entries=n_rows,
               kernel_ms=time_ms(torch, lambda: gab_fused.gab_fused(*args),
                                 flush),
               composition_ms=time_ms(torch, lambda: merged_composition(
                   torch, prog, ev, inv, args), flush),
               plain_ms=time_ms(torch, lambda: ref.gab_fused_ref(*args),
                                flush))
    log(f"{what}: kernel {row['kernel_ms']:.4f} ms, merged-mode "
        f"composition {row['composition_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); equal to "
        f"the composition; mask equal on {n_clear} of {n_rows} entries")
    return row


def check_fused_kernel(torch, tile, plan, flush):
    """Fused kernel at the tiles' shapes (src_vals [edge_cap(, Q)], old
    [row_cap(, Q)], the largest tile's num_rows) against ref.gab_fused_ref
    and the merged-mode composition."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    dst = torch.from_numpy(tile.dst_local).to(dev)
    rows = []
    err = 0.0
    for name, prog in fused_cases().items():
        # Q + 1 = 9: MultiSourceBFS after a scheduled admission (phase 12)
        qs = (1, 4, NUM_QUERIES) + ((NUM_QUERIES + 1,) if name == "bfs"
                                    else ())
        for q in qs:
            case = fused_inputs(torch, prog, dst, tile.meta.num_rows,
                                plan.row_cap, q, gen)
            m0 = non_torch_device_bytes(torch)
            row = check_fused_case(torch, case, flush,
                                   f"fused {name} Q={q}")
            # the hub launch's scratch grows inside torch's allocator: the
            # first Q = 9 call (more column passes, more scratch, the Q = 8
            # kernels) adds nothing outside it
            row["non_torch_growth"] = non_torch_device_bytes(torch) - m0
            if q == NUM_QUERIES + 1 and row["non_torch_growth"]:
                raise AssertionError(
                    f"fused {name} Q={q}: {row['non_torch_growth']:+d} "
                    "bytes outside torch's allocator")
            rows.append(dict(spec=name, **row))
            err = max(err, row["max_abs_err"])
    log(f"fused kernel: all cases agree, max |err| {err:.3g}")
    return rows, err


def check_fused_padding_hub(torch, tile, plan, flush):
    """A tile whose padding would be a hub row (more than 8,192 edges, far
    past the hub launch's two multiples of 256): the largest tile's dst
    with num_rows lowered to the row of its PAD_HUB_EDGES-th last real
    edge and every edge from that row's first on pointing at it, as
    padding does.  The
    fused kernel must skip that row (it keeps old), agree with the plain
    version and equal the merged-mode composition."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    d_np = tile.dst_local.copy()
    cut = min(PAD_HUB_EDGES, tile.meta.num_edges // 2)
    nr = int(d_np[tile.meta.num_edges - cut])
    first = int(np.searchsorted(d_np, nr))
    d_np[first:] = nr
    dst = torch.from_numpy(d_np).to(dev)
    pad = d_np.shape[0] - first
    if cut == PAD_HUB_EDGES and pad <= 2 * 4096:
        raise AssertionError(f"padding of {pad} edges would be no hub")
    rows = []
    for name in ("pagerank", "bfs"):
        prog = fused_cases()[name]
        for q in (1, NUM_QUERIES):
            case = fused_inputs(torch, prog, dst, nr, plan.row_cap, q, gen)
            row = check_fused_case(
                torch, case, flush, f"fused {name} Q={q}, num_rows {nr}, "
                f"{pad} padding edges at dst == num_rows")
            rows.append(dict(spec=name, padding_edges=pad, **row))
    return rows, max(r["max_abs_err"] for r in rows)


def check_compact_kernel(torch, nv, flush):
    """Compact kernel against ref.compact: indices equal, value bits equal."""
    from repro_torch.core.comm import sparse_capacity
    from repro_torch.kernels import compact, ref

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    big = 1 << 25
    f32 = torch.float32
    # (V, density, dtype, fill, K or None for sparse_capacity(V), mask offset)
    cases = [(nv, 0.0, f32, None, None, 0), (nv, 1e-3, f32, None, None, 0),
             (nv, 0.05, f32, None, None, 0), (nv, 0.399, f32, None, None, 0),
             (nv, 0.6, f32, None, None, 0), (big, 0.01, f32, None, None, 0),
             (nv, 0.05, torch.int32, None, None, 0),
             (nv, 0.05, f32, 7, None, 0),
             (nv, 0.05, f32, None, None, 1),          # mask view, 1-byte offset
             (nv - 1, 0.05, f32, None, None, 0),      # V not a multiple of 16
             (nv, 0.05, f32, None, 0, 0),             # K = 0
             (1000, 0.5, f32, None, 1500, 0)]         # K > V
    rows = []
    for n, density, dtype, fill, k, offset in cases:
        k = sparse_capacity(n) if k is None else k
        m = (torch.rand(n + offset, generator=gen, device=dev)
             < density)[offset:]
        if dtype == torch.float32:
            v = torch.randn(n, generator=gen, device=dev)
        else:
            v = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        gi, gv = compact.compact(m, v, k, fill)
        wi, wv = ref.compact(m, v, k, fill)
        what = (f"compact V={n} density={density} K={k} {dtype} "
                f"fill={'V' if fill is None else fill} offset={offset}")
        if not (torch.equal(gi, wi)
                and torch.equal(gv.view(torch.int32), wv.view(torch.int32))):
            raise AssertionError(f"{what}: kernel differs from plain version")
        pop = int(m.sum())
        if k == 0 or n < nv - 1:
            log(f"{what}: {pop} set, equal")
            continue
        fill_v = n if fill is None else fill

        def library_full():
            # the whole function in PyTorch: K slots of (fill, 0), then the
            # first K set indices and their values
            idx = torch.full((k,), fill_v, dtype=torch.int32, device=dev)
            val = torch.zeros(k, dtype=v.dtype, device=dev)
            nz = torch.nonzero(m).squeeze(1)[:k]
            idx[:nz.shape[0]] = nz.to(torch.int32)
            val[:nz.shape[0]] = v[nz]
            return idx, val
        nbytes = n + 4 * min(pop, k) + 8 * k
        b_ms, b_by = bound(nbytes, n)
        li, lv = library_full()
        if not (torch.equal(li, wi)
                and torch.equal(lv.view(torch.int32), wv.view(torch.int32))):
            raise AssertionError(f"{what}: the PyTorch yardstick differs")
        row = dict(
            n=n, density=density, capacity=k, popcount=pop,
            dtype=str(dtype), fill=fill, offset=offset,
            kernel_ms=time_ms(torch, lambda: compact.compact(m, v, k, fill),
                              flush),
            plain_ms=time_ms(torch, lambda: ref.compact(m, v, k, fill),
                             flush),
            library_ms=time_ms(torch, lambda: v[torch.nonzero(m).squeeze(1)
                                                [:k]], flush, spin=False),
            library_full_ms=time_ms(torch, library_full, flush, spin=False),
            bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log(f"{what}: {pop} set, equal; kernel {row['kernel_ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, nonzero+gather "
            f"{row['library_ms']:.4f} ms, full function in PyTorch "
            f"{row['library_full_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log("compact kernel: all cases equal")
    return rows, 0.0


def device_edges(torch, src, dst):
    return torch.from_numpy(src).to(DEV), torch.from_numpy(dst).to(DEV)


def inv_degree(torch, out_degree):
    """float64 of the engine's float32 1 / out-degree (0 for sinks)."""
    od = torch.from_numpy(np.asarray(out_degree)).to(DEV).double()
    return torch.where(od > 0, 1.0 / od, 0.0).float().double()


def ref_pagerank(torch, src, dst, out_degree, nv, steps):
    """float64 PageRank power iteration over the edge list, in plain
    PyTorch on the card (index_add_, independent of the engine's path)."""
    s, d = device_edges(torch, src, dst)
    w = inv_degree(torch, out_degree)[s]
    pr = torch.ones(nv, dtype=torch.float64, device=DEV)
    for _ in range(steps):
        msg = torch.zeros(nv, dtype=torch.float64, device=DEV)
        pr = 0.15 + 0.85 * msg.index_add_(0, d, pr[s] * w)
    out = pr.cpu().numpy()
    del s, d, w, pr, msg
    torch.cuda.empty_cache()
    return out


def ref_bfs(torch, src, dst, nv, sources):
    """BFS levels [V, Q] float32 from each source (inf where unreached),
    level-synchronous over the edge list in plain PyTorch on the card, one
    source at a time."""
    s, d = device_edges(torch, src, dst)
    out = torch.full((nv, len(sources)), float("inf"), dtype=torch.float32,
                     device=DEV)
    for q, v in enumerate(sources):
        level = out[:, q]
        level[v] = 0.0
        frontier = torch.zeros(nv, dtype=torch.bool, device=DEV)
        frontier[v] = True
        depth = 0
        while True:
            reach = torch.zeros_like(frontier)
            reach[d[frontier[s]]] = True
            frontier = reach & torch.isinf(level)
            if not bool(frontier.any()):
                break
            depth += 1
            level.masked_fill_(frontier, float(depth))
    levels = out.cpu().numpy()
    del s, d, out, level, frontier, reach
    torch.cuda.empty_cache()
    return levels


def ref_ppr(torch, src, dst, out_degree, nv, seeds, steps, tol):
    """float64 personalized PageRank with the engine's update gate (a cell
    takes its new value only where it moved by more than ``tol``), in
    plain PyTorch on the card, one seed at a time."""
    s, d = device_edges(torch, src, dst)
    w = inv_degree(torch, out_degree)[s]
    out = np.empty((nv, len(seeds)))
    for q, v in enumerate(seeds):
        seed_mass = torch.zeros(nv, dtype=torch.float64, device=DEV)
        seed_mass[v] = 1.0
        x = seed_mass.clone()
        for _ in range(steps):
            msg = torch.zeros(nv, dtype=torch.float64, device=DEV)
            new = 0.15 * seed_mass + 0.85 * msg.index_add_(0, d, x[s] * w)
            x = torch.where((new - x).abs() > tol, new, x)
        out[:, q] = x.cpu().numpy()
    del s, d, w, seed_mass, x, msg, new
    torch.cuda.empty_cache()
    return out


def steady_ms(res):
    """Mean ms a superstep over supersteps 1+ (superstep 0 alone if the
    run had one)."""
    h = res.history
    steady = h[1:] if len(h) > 1 else h
    return 1e3 * float(np.mean([x.seconds for x in steady]))


def app_summary(name, res):
    h = res.history
    s = dict(
        app=name, supersteps=res.supersteps, converged=res.converged,
        ms_per_superstep=1e3 * res.total_seconds() / max(len(h), 1),
        steady_ms=steady_ms(res),
        seconds=res.total_seconds(),
        load_seconds=sum(x.load_seconds for x in h),
        compute_seconds=sum(x.compute_seconds for x in h),
        tiles_processed=sum(x.tiles_processed for x in h),
        tiles_skipped=sum(x.tiles_skipped for x in h),
        raw_bytes=sum(x.raw_bytes for x in h),
        wire_bytes=sum(x.wire_bytes for x in h),
        per_superstep_ms=[1e3 * x.seconds for x in h],
        load_ms=[1e3 * x.load_seconds for x in h],
        compute_ms=[1e3 * x.compute_seconds for x in h],
        updated=[x.updated_vertices for x in h],
        updated_pairs=[x.updated_pairs for x in h],
        per_query_supersteps=(None if res.per_query_supersteps is None
                              else [int(x) for x in
                                    res.per_query_supersteps]))
    log(f"{name}: {s['supersteps']} supersteps, {s['ms_per_superstep']:.1f} "
        f"ms/superstep ({s['steady_ms']:.1f} steady), load "
        f"{s['load_seconds']:.2f} s, compute {s['compute_seconds']:.2f} s, "
        f"tiles {s['tiles_processed']} run / {s['tiles_skipped']} skipped, "
        f"broadcast {s['raw_bytes']} raw / {s['wire_bytes']} wire bytes")
    return s


def open_store(root):
    from repro_torch.graphio.formats import TileStore

    store = TileStore(root)
    store.load_meta()
    return store


def side_worker(name, args, results):
    """Runs ``name(torch, *args)`` (a function of this script) in a spawned
    process; puts ("ok", (its log lines, its result)) or ("error", (its
    log lines, the traceback)) on ``results``."""
    import traceback

    import torch

    global log
    lines = []
    log = lines.append
    try:
        results.put(("ok", (lines, globals()[name](torch, *args))))
    except BaseException:
        results.put(("error", (lines, traceback.format_exc())))


class Side:
    """A part of a phase run in a spawned process beside the main sequence
    (the out-of-core parts: single-threaded host work that leaves the card
    idle); its kernels count in its process.  ``join`` logs its lines and
    returns its result, or raises with its traceback."""

    def __init__(self, name, *args):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.name, self.t0 = name, time.perf_counter()
        self.results = ctx.Queue()
        self.proc = ctx.Process(target=side_worker,
                                args=(name, args, self.results), daemon=True)
        self.proc.start()

    def join(self):
        import queue

        t_wait = time.perf_counter()
        got = None
        try:
            while got is None:
                try:
                    got = self.results.get(timeout=5)
                except queue.Empty:
                    if not self.proc.is_alive():
                        raise AssertionError(
                            f"{self.name}: its process exited with code "
                            f"{self.proc.exitcode} and no result") from None
        finally:
            self.proc.join(timeout=60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout=10)
        status, (lines, payload) = got
        for line in lines:
            log(line)
        if status != "ok":
            raise AssertionError(f"{self.name} (side process): {payload}")
        log(f"{self.name}: side process done {time.perf_counter() - self.t0:.1f}"
            f" s after its start; waited {time.perf_counter() - t_wait:.1f} s")
        return payload


def engine(store, **kw):
    from repro_torch.core.engine import EngineConfig, OutOfCoreEngine

    return OutOfCoreEngine(store, EngineConfig(num_servers=1, device=DEV,
                                               seg_impl="fused", **kw))


def main_path(torch, store, src, dst):
    from repro_torch.core.apps import BFS, InDegree, PageRank

    eng = engine(store)
    nv = eng.plan.num_vertices
    reset_launches()
    pr = eng.run(PageRank(), max_supersteps=PR_SUPERSTEPS)
    bfs = eng.run(BFS(source=0), max_supersteps=BFS_MAX_SUPERSTEPS)
    indeg = eng.run(InDegree(), max_supersteps=1)
    launches = read_launches()
    require_launches(launches, ("segment_reduce", "gab_fused"), "main path")

    summaries = [app_summary("pagerank", pr), app_summary("bfs", bfs),
                 app_summary("indegree", indeg)]
    for arr in (pr.values, bfs.values, indeg.values):
        if arr.shape != (nv,) or arr.dtype != np.float32:
            raise AssertionError(f"bad result {arr.shape} {arr.dtype}")
    want = ref_pagerank(torch, src, dst, eng.out_degree, nv, PR_SUPERSTEPS)
    if not np.isfinite(pr.values).all():
        raise AssertionError("pagerank: non-finite values")
    rel = float(np.max(np.abs(pr.values - want) / want))
    log(f"pagerank vs the float64 reference: max rel err {rel:.3g} "
        f"(limit {PR_RTOL})")
    if rel > PR_RTOL:
        raise AssertionError("pagerank disagrees with the reference")
    if not bfs.converged:
        raise AssertionError("bfs did not converge")
    level = ref_bfs(torch, src, dst, nv, (0,))[:, 0]
    if not np.array_equal(bfs.values, level):
        raise AssertionError("bfs differs from the reference BFS")
    log(f"bfs equals the reference BFS: {int(np.isfinite(level).sum())} reached, "
        f"depth {int(level[np.isfinite(level)].max())}")
    if not np.array_equal(indeg.values, np.bincount(dst, minlength=nv)):
        raise AssertionError("indegree differs from np.bincount")
    log("indegree equals np.bincount")
    return eng, launches, summaries, rel, pr, bfs, indeg


def compact_path(torch, bfs):
    """ops.compact over each BFS superstep's sparse broadcast: the
    vertices superstep k updated (level k + 1) and their levels."""
    from repro_torch.core.comm import sparse_capacity
    from repro_torch.kernels import ops

    nv = bfs.values.shape[0]
    k = sparse_capacity(nv)
    values = torch.from_numpy(bfs.values).to(DEV)
    reset_launches()
    counts = []
    for step in range(bfs.supersteps):
        mask = bfs.values == step + 1
        idx, vals = ops.compact(torch.from_numpy(mask).to(DEV), values, k)
        want = np.nonzero(mask)[0][:k]
        n = len(want)
        gi, gv = idx.cpu().numpy(), vals.cpu().numpy()
        if not (np.array_equal(gi[:n], want)
                and np.array_equal(gv[:n], bfs.values[want])
                and (gi[n:] == nv).all() and (gv[n:] == 0).all()):
            raise AssertionError(f"compact path: superstep {step} differs "
                                 "from numpy")
        counts.append(int(mask.sum()))
    launches = read_launches()
    require_launches(launches, ("compact",), "compact path")
    log(f"compact path: {bfs.supersteps} BFS payloads (K = {k}, "
        f"{counts} set) equal numpy")
    return launches, counts


def profiled_step(torch, session, name):
    """One ``session.step()`` under torch.profiler: wall time, device busy
    share, device time by kernel and copy direction, and the host time of
    the out-of-core gather and writeback (record_function ranges)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = session.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels and copies): a CPU op's device time
    # repeats its kernels'; "Activity Buffer Request" is the profiler's own
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    by_name = sorted(((e.device_time_total, e.key, e.count)
                      for e in events
                      if e.device_type == cuda
                      and not e.key.startswith("Activity Buffer")),
                     reverse=True)
    busy = sum(t for t, _, _ in by_name) / 1e6

    def device_ms(pred):
        return sum(t for t, k, _ in by_name if pred(k)) / 1e3

    def host_ms(key):
        return sum(e.cpu_time_total for e in events if e.key == key) / 1e3

    out = dict(app=name, wall_s=wall, device_busy_s=busy,
               device_busy_share=busy / wall if wall else 0.0,
               h2d_ms=device_ms(lambda k: "HtoD" in k),
               d2h_ms=device_ms(lambda k: "DtoH" in k),
               gab_kernels_ms=device_ms(
                   lambda k: "row_kernel" in k or "hub_kernel" in k),
               vstate_gather_ms=host_ms("vstate_gather"),
               vstate_writeback_ms=host_ms("vstate_writeback"),
               superstep_s=stats.seconds,
               top=[dict(name=k[:80], device_ms=t / 1e3, count=c)
                    for t, k, c in by_name[:12]])
    log(f"profiled {name} superstep: wall {wall:.3f} s, device busy "
        f"{busy:.4f} s ({100 * out['device_busy_share']:.1f}%), H2D "
        f"{out['h2d_ms']:.1f} ms, D2H {out['d2h_ms']:.1f} ms, GAB kernels "
        f"{out['gab_kernels_ms']:.1f} ms, vertex-state gather "
        f"{out['vstate_gather_ms']:.1f} ms and writeback "
        f"{out['vstate_writeback_ms']:.1f} ms on the host")
    for row in out["top"]:
        log(f"  {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    return out


def profile_superstep(torch, eng, prog, name):
    """One superstep (after a warm one) under torch.profiler (see
    profiled_step)."""
    session = eng.open_session(prog, max_supersteps=2)
    session.step()          # warm: the first superstep
    try:
        return profiled_step(torch, session, name)
    finally:
        session.close()


def pick_sources(out_degree):
    """Vertex 0 and seven vertices with out-degree > 0 drawn from SEED."""
    rng = np.random.default_rng(SEED)
    cand = np.nonzero(out_degree > 0)[0]
    cand = cand[cand != 0]
    more = rng.choice(cand, NUM_QUERIES - 1, replace=False)
    return (0,) + tuple(int(v) for v in more)


def batched_apps(torch, store, src, dst, bfs):
    from repro_torch.core.apps import (LandmarkDistances, MultiSourceBFS,
                                       PersonalizedPageRank)

    # tile skipping off: each run would rebuild the filters (12-20 s of
    # its superstep 0) and R-MAT skips no tile; phase 12's in-memory
    # session runs the batched skip pre-pass
    eng = engine(store, tile_skipping=False)
    nv = eng.plan.num_vertices
    sources = pick_sources(eng.out_degree)
    log(f"batched sources (Q = {len(sources)}): {sources}")
    reset_launches()
    msbfs = eng.run(MultiSourceBFS(sources=sources),
                    max_supersteps=BFS_MAX_SUPERSTEPS)
    lm = eng.run(LandmarkDistances(landmarks=sources),
                 max_supersteps=BFS_MAX_SUPERSTEPS)
    ppr = eng.run(PersonalizedPageRank(seeds=sources),
                  max_supersteps=PPR_SUPERSTEPS)
    ppr1 = eng.run(PersonalizedPageRank(seeds=sources[:1]),
                   max_supersteps=PPR_SUPERSTEPS)
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "batched apps")
    summaries = [app_summary("msbfs", msbfs), app_summary("landmarks", lm),
                 app_summary("ppr", ppr), app_summary("ppr_q1", ppr1)]

    shape = (nv, len(sources))
    for name, res in (("msbfs", msbfs), ("landmarks", lm), ("ppr", ppr)):
        if res.values.shape != shape or res.values.dtype != np.float32:
            raise AssertionError(f"{name}: bad result {res.values.shape} "
                                 f"{res.values.dtype}")
    if not msbfs.converged or not lm.converged:
        raise AssertionError("msbfs / landmarks did not converge")
    levels = ref_bfs(torch, src, dst, nv, sources)
    for q, s in enumerate(sources):
        if not np.array_equal(msbfs.values[:, q], levels[:, q]):
            raise AssertionError(f"msbfs column {q} (source {s}) differs "
                                 "from the reference BFS")
    if not np.array_equal(msbfs.values[:, 0], bfs.values):
        raise AssertionError("msbfs column 0 differs from the Q = 1 BFS")
    log(f"msbfs equals the reference BFS in all {len(sources)} columns; column 0 "
        f"equals the single-query BFS; per-query supersteps "
        f"{list(msbfs.per_query_supersteps)}")
    if not (np.array_equal(lm.values, msbfs.values)
            and np.array_equal(lm.per_query_supersteps,
                               msbfs.per_query_supersteps)):
        raise AssertionError("landmarks differ from msbfs")
    log("landmarks (edge weight 1.0) equal msbfs, per-query supersteps too")

    tol = PersonalizedPageRank().update_tol
    want = ref_ppr(torch, src, dst, eng.out_degree, nv, sources,
                   PPR_SUPERSTEPS, tol)
    if not np.isfinite(ppr.values).all():
        raise AssertionError("ppr: non-finite values")
    big = want >= PPR_MIN_ENTRY
    err = np.abs(ppr.values - want)[big]
    rel_all = err / want[big]
    over = rel_all > PR_RTOL
    n_over = int(over.sum())
    flip_err = float(err[over].max()) if n_over else 0.0
    rel = float(rel_all[~over].max()) if n_over < rel_all.size else 0.0
    l1 = float(np.max(np.abs(ppr.values - want).sum(axis=0)))
    log(f"ppr vs the float64 reference: max rel err {rel:.3g} on {rel_all.size - n_over}"
        f" entries >= {PPR_MIN_ENTRY} (limit {PR_RTOL}); {n_over} gate flips "
        f"(max rel {float(rel_all.max()):.3g}, max abs err {flip_err:.3g}, "
        f"limit {PPR_SUPERSTEPS * tol:.3g}); max L1 per column {l1:.3g} "
        f"(limit {PPR_L1})")
    if (l1 > PPR_L1 or flip_err > PPR_SUPERSTEPS * tol
            or n_over > PPR_MAX_FLIP_SHARE * rel_all.size):
        raise AssertionError("ppr disagrees with the reference")
    if not np.array_equal(ppr.values[:, 0], ppr1.values[:, 0]):
        raise AssertionError("ppr column 0 differs from the Q = 1 run")
    log("ppr column 0 equals the Q = 1 PPR run")
    return (sources, launches, summaries, msbfs, levels,
            dict(ppr_max_rel_err=rel, ppr_gate_flips=n_over,
                 ppr_entries=int(rel_all.size),
                 ppr_flip_max_abs_err=flip_err, ppr_max_l1=l1))


def modes(torch, store, sources, pr, msbfs):
    """PageRank (PR_SUPERSTEPS) and MultiSourceBFS (to convergence) in
    each mode, equal to the tiled runs."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank

    out = []
    reset_launches()
    for mode in (dict(engine_mode="stacked"), dict(engine_mode="merged"),
                 dict(pipeline=True)):
        name = next(f"{k}={v}" for k, v in mode.items())
        eng = engine(store, tile_skipping=False, **mode)
        p = eng.run(PageRank(), max_supersteps=PR_SUPERSTEPS)
        m = eng.run(MultiSourceBFS(sources=sources),
                    max_supersteps=BFS_MAX_SUPERSTEPS)
        if not same_bits(p.values, pr.values):
            raise AssertionError(f"{name}: pagerank differs from tiled")
        if not (same_bits(m.values, msbfs.values)
                and np.array_equal(m.per_query_supersteps,
                                   msbfs.per_query_supersteps)):
            raise AssertionError(f"{name}: msbfs differs from tiled")
        log(f"{name}: pagerank and msbfs equal the tiled runs bit for bit")
        out.append(dict(mode=name, pagerank=app_summary(f"pagerank {name}", p),
                        msbfs=app_summary(f"msbfs {name}", m)))
        del eng
        torch.cuda.empty_cache()
    launches = read_launches()
    require_launches(launches, ("segment_reduce", "gab_fused"), "modes")
    return out, launches


def same_bits(a, b):
    """Whether two host arrays hold the same bits (shape, dtype, bytes)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def non_torch_device_bytes(torch):
    """Device bytes in use outside torch's caching allocator (the CUDA
    context and the kernels' code; the hub launch's scratch comes from
    torch's allocator)."""
    free, total = torch.cuda.mem_get_info()
    return total - free - torch.cuda.memory_reserved()


def vstate_summary(name, res, tiled_ms, store_stats, k):
    """Per-superstep vertex-state counters of an out-of-core run, beside
    the in-memory tiled run's steady ms per superstep."""
    h = res.history
    s = app_summary(name, res)
    s.update(
        intervals=k, tiled_steady_ms=tiled_ms,
        faults=[x.vstate_faults for x in h],
        load_bytes=[x.vstate_load_bytes for x in h],
        spill_bytes=[x.vstate_spill_bytes for x in h],
        dirty_intervals=[x.vstate_dirty_intervals for x in h],
        store=store_stats)
    log(f"{name}: {k} intervals, {s['steady_ms']:.1f} ms/superstep steady "
        f"against tiled {tiled_ms:.1f} ({s['steady_ms'] / tiled_ms:.2f}x); "
        f"faults {s['faults']}, faulted-in bytes {s['load_bytes']}, spilled "
        f"bytes {s['spill_bytes']}, dirty intervals {s['dirty_intervals']}; "
        f"store: {store_stats['faults']} faults, {store_stats['spills']} "
        f"spills, compress {store_stats['compress_seconds']:.2f} s, "
        f"decompress {store_stats['decompress_seconds']:.2f} s, disk "
        f"{store_stats['disk_seconds']:.2f} s")
    if not (sum(s["faults"]) and sum(s["dirty_intervals"])):
        raise AssertionError(f"{name}: the vertex budget does not bind")
    return s


def counting_h2d(torch, counter):
    """Wrap engine.run_tile_sharded to add the bytes of the host inputs it
    copies to the device to counter[0]."""
    from repro_torch.core import engine as engine_mod

    real = engine_mod.run_tile_sharded

    def wrapped(*args, **kw):
        for a in list(args) + list(kw.values()):
            for x in (a.values() if isinstance(a, dict) else (a,)):
                if isinstance(x, (np.ndarray, torch.Tensor)):
                    counter[0] += x.nbytes
        return real(*args, **kw)

    engine_mod.run_tile_sharded = wrapped
    return lambda: setattr(engine_mod, "run_tile_sharded", real)


def time_footprints(store, plan):
    """Seconds to read every tile and compute its source footprint over
    the OOC_INTERVALS plan: what the out-of-core engine adds to each tile
    load on a store written without an interval plan."""
    from repro_torch.core.partition import plan_intervals
    from repro_torch.core.tiles import compute_source_footprint

    iv = plan_intervals(plan.splitter, OOC_INTERVALS)
    t0 = time.perf_counter()
    read = 0.0
    for t in range(plan.num_tiles):
        r0 = time.perf_counter()
        tile = store.read_tile(t)
        read += time.perf_counter() - r0
        compute_source_footprint(tile.src, tile.meta.num_edges, iv.splitter)
    total = time.perf_counter() - t0
    out = dict(intervals=int(iv.num_intervals), read_s=read,
               footprint_s=total - read)
    log(f"footprints: {iv.num_intervals} intervals (OOC_INTERVALS = "
        f"{OOC_INTERVALS}, cut at tile boundaries); {plan.num_tiles} tiles "
        f"read in {read:.2f} s, footprints computed in "
        f"{out['footprint_s']:.2f} s")
    return out


def ooc_phase(torch, store_root, indeg):
    """Out-of-core vertex state on the main store with OOC_INTERVALS
    intervals: PageRank (budget OOC_PR_BUDGET, OOC_PR_SUPERSTEPS
    supersteps, superstep 1 profiled) and InDegree (OOC_PR_BUDGET, 1
    superstep, the
    segment kernel), each bit for bit equal to the in-memory tiled run of
    as many supersteps; the budget must bind.  MultiSourceBFS under
    OOC_MSBFS_BUDGET runs in phase 12's out-of-core session.  Runs in a
    side process (Side)."""
    from repro_torch.core.apps import InDegree, PageRank

    store = open_store(store_root)
    num_tiles = store.load_plan().num_tiles
    out, launches = [], {}
    mem = engine(store, tile_skipping=False).run(
        PageRank(), max_supersteps=OOC_PR_SUPERSTEPS)
    reset_launches()
    eng = engine(store, tile_skipping=False, num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_PR_BUDGET)
    sess = eng.open_session(PageRank(), max_supersteps=OOC_PR_SUPERSTEPS)
    try:
        sess.step()
        h2d = [0]
        restore = counting_h2d(torch, h2d)
        try:
            prof = profiled_step(torch, sess, "pagerank ooc")
        finally:
            restore()
        prof["h2d_bytes"] = h2d[0]
        log(f"  H2D of the sharded step: {h2d[0]} bytes")
        while not sess.finished:
            sess.step()
        res = sess.result()
    finally:
        sess.close()
    launches["pagerank"] = read_launches()
    if not same_bits(res.values, mem.values):
        raise AssertionError("pagerank ooc differs from the tiled run")
    out.append(vstate_summary("pagerank ooc", res, steady_ms(mem),
                              eng.vstate.stats.as_dict(),
                              eng.vstate.num_intervals))
    if launches["pagerank"]["gab_fused"] != num_tiles * OOC_PR_SUPERSTEPS:
        raise AssertionError(f"pagerank ooc: {launches['pagerank']} "
                             f"launches, {num_tiles} a superstep expected")

    # tile skipping on, as in phase 5: its one superstep builds the filters
    eng = engine(store, num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_PR_BUDGET)
    reset_launches()
    res = eng.run(InDegree(), max_supersteps=1)
    launches["indegree"] = read_launches()
    if not same_bits(res.values, indeg.values):
        raise AssertionError("indegree ooc differs from the tiled run")
    if launches["indegree"]["segment_reduce"] != num_tiles:
        raise AssertionError(f"indegree ooc: {launches['indegree']}")
    out.append(vstate_summary("indegree ooc", res, steady_ms(indeg),
                              eng.vstate.stats.as_dict(),
                              eng.vstate.num_intervals))
    for key in ("faults", "spill_bytes", "dirty_intervals"):
        if not all(sum(r[key]) for r in out):
            raise AssertionError(f"ooc: no {key}: the budget does not bind")
    total = {k: sum(v[k] for v in launches.values())
             for k in launches["pagerank"]}
    require_launches(total, ("segment_reduce", "gab_fused"), "ooc")
    log("ooc: pagerank and indegree equal the tiled runs bit for bit")
    return out, prof, total


def pick_admitted(src, dst, out_degree, sources):
    """Two more sources drawn from SEED among vertices with out-degree > 0
    that are not sources already: the ninth (scheduled) query among those
    whose out-neighbours are all sinks, so its BFS converges in two
    supersteps and its column retires inside the out-of-core window; the
    tenth (admitted through the session) among all of them."""
    rng = np.random.default_rng(SEED)
    cand = np.setdiff1d(np.nonzero(out_degree > 0)[0], np.asarray(sources))
    feeds = np.bincount(src[out_degree[dst] > 0], minlength=len(out_degree))
    s9 = int(rng.choice(cand[feeds[cand] == 0]))
    s10 = int(rng.choice(cand[cand != s9]))
    return s9, s10


def admission_script(torch, eng, sources, s10, max_supersteps=None):
    """The session the admission phase drives: MultiSourceBFS over the
    sources, at most Q + 1 live columns, the engine's admit_plan bringing
    the ninth query in after superstep 1; query DRAIN_QID drained at the
    end of superstep DRAIN_AT, and s10 admitted through ``admit()`` once
    a column has left.  Returns (result, per-superstep rows, the drained
    column's partial values, s10's query id)."""
    from repro_torch.core.apps import MultiSourceBFS
    from repro_torch.kernels import gab_fused

    sess = eng.open_session(MultiSourceBFS(sources=sources),
                            q_slots=len(sources) + 1,
                            max_supersteps=max_supersteps)
    steps, partial, g10 = [], None, None
    try:
        while not sess.finished:
            ss = sess.superstep
            if ss == DRAIN_AT:
                sess.drain([DRAIN_QID])
            l0, m0 = gab_fused.LAUNCHES, non_torch_device_bytes(torch)
            st = sess.step()
            steps.append(dict(
                superstep=ss, active_queries=st.active_queries,
                fused_launches=gab_fused.LAUNCHES - l0,
                non_torch_growth=non_torch_device_bytes(torch) - m0,
                ms=1e3 * st.seconds, admitted=list(st.admitted_queries),
                drained=list(st.drained_queries),
                retired=list(st.retired_queries),
                vstate_faults=st.vstate_faults,
                vstate_load_bytes=st.vstate_load_bytes,
                vstate_spill_bytes=st.vstate_spill_bytes,
                vstate_dirty_intervals=st.vstate_dirty_intervals))
            if st.drained_queries:
                partial = sess.query_result(DRAIN_QID)
            if (g10 is None and not sess.finished
                    and (st.retired_queries or st.drained_queries)):
                g10 = sess.admit([s10])[0]
        res = sess.result()
    finally:
        sess.close()
    return res, steps, partial, g10


def admission_phase(torch, store, sources, s9, s10, msbfs, levels,
                    ooc_part):
    """Mid-run admission at SCALE 22: the session of admission_script in
    memory to convergence (tile skipping on, as users run it), each
    admitted column against a fresh single-query run, the drained one
    against the reference BFS levels up to DRAIN_AT + 1; then its first
    ADMIT_OOC_SUPERSTEPS supersteps in memory and under OOC_MSBFS_BUDGET,
    equal bit for bit — the latter is also the out-of-core MultiSourceBFS
    run at Q = 8 (supersteps 0 and 1, the ninth query admitted at the
    barrier of 1; with a window of 3, also Q = 9 at superstep 2, at whose
    barrier query DRAIN_QID drains).  The launch counters are read
    around the two sessions alone: "admission" (in memory) and
    "admission ooc".  The out-of-core part (admission_ooc) ran in a side
    process: ``ooc_part`` is its result."""
    from repro_torch.core.apps import MultiSourceBFS

    plan = ((1, (s9,)),)
    log(f"admission: ninth source {s9} (its out-neighbours are sinks) "
        f"scheduled after superstep 1, tenth {s10} through admit(); query "
        f"{DRAIN_QID} drained at superstep {DRAIN_AT}")
    launches = {}
    eng = engine(store, admit_plan=plan)
    reset_launches()
    res, steps, partial, g10 = admission_script(torch, eng, sources, s10)
    launches["admission"] = read_launches()
    require_launches(launches["admission"], ("gab_fused",), "admission")
    for row in steps:
        log(f"  superstep {row['superstep']}: {row['active_queries']} live, "
            f"{row['fused_launches']} fused launches, {row['ms']:.1f} ms, "
            f"admitted {row['admitted']}, drained {row['drained']}, retired "
            f"{row['retired']}, non-torch device bytes "
            f"{row['non_torch_growth']:+d}")
    q = len(sources)
    nine = [r for r in steps if r["active_queries"] == q + 1]
    if not res.converged or not nine or g10 is None or partial is None:
        raise AssertionError("admission: the session did not run its script")
    num_tiles = store.load_plan().num_tiles
    if any(r["fused_launches"] != num_tiles for r in nine):
        raise AssertionError(f"admission: fused launches at Q = {q + 1}: "
                             f"{[r['fused_launches'] for r in nine]}")
    pq = res.per_query_supersteps
    keep = [c for c in range(q) if c != DRAIN_QID]
    if not (same_bits(res.values[:, keep], msbfs.values[:, keep])
            and np.array_equal(pq[keep], msbfs.per_query_supersteps[keep])):
        raise AssertionError("admission: an original column differs from "
                             "the Q = 8 run")
    for gq, s in ((q, s9), (g10, s10)):
        fresh = engine(store, tile_skipping=False).run(
            MultiSourceBFS(sources=(s,)), max_supersteps=BFS_MAX_SUPERSTEPS)
        if not (same_bits(res.values[:, gq], fresh.values[:, 0])
                and pq[gq] == fresh.per_query_supersteps[0]):
            raise AssertionError(f"admission: query {gq} (source {s}) "
                                 "differs from its fresh run")
    lv = levels[:, DRAIN_QID]
    want = np.where(lv <= DRAIN_AT + 1, lv, np.float32(np.inf))
    if not (pq[DRAIN_QID] == -1
            and same_bits(res.values[:, DRAIN_QID], partial)
            and same_bits(partial, want)):
        raise AssertionError("admission: the drained column is not its "
                             "partial run")
    log(f"admission: {res.supersteps} supersteps, Q up to {q + 1}; queries "
        f"{q} and {g10} equal their fresh runs (supersteps "
        f"{int(pq[q])}, {int(pq[g10])}), query {DRAIN_QID} holds its BFS "
        f"levels up to {DRAIN_AT + 1}, the other originals equal the "
        f"Q = {q} run")

    ooc_summary, mem_steps, ooc_steps, launches["admission ooc"] = ooc_part
    return dict(s9=s9, s10=s10, q10=g10, supersteps=res.supersteps,
                per_query_supersteps=[int(x) for x in pq], steps=steps,
                mem_steps=mem_steps, ooc_steps=ooc_steps, ooc=ooc_summary,
                fused_launches_at_q9=[r["fused_launches"] for r in nine],
                non_torch_growth_at_q9=[r["non_torch_growth"]
                                        for r in nine]), launches


def admission_ooc(torch, store_root, sources, s9, s10):
    """Phase 12's out-of-core part, in a side process: the admission
    session's first ADMIT_OOC_SUPERSTEPS supersteps in memory and under
    OOC_MSBFS_BUDGET, equal bit for bit, the launch counters read around
    the out-of-core session ("admission ooc")."""
    store = open_store(store_root)
    q = len(sources)
    plan = ((1, (s9,)),)
    num_tiles = store.load_plan().num_tiles
    cut = ADMIT_OOC_SUPERSTEPS
    mem, mem_steps, _, _ = admission_script(
        torch, engine(store, tile_skipping=False, admit_plan=plan), sources,
        s10, cut)
    eng = engine(store, tile_skipping=False, admit_plan=plan,
                 num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_MSBFS_BUDGET)
    reset_launches()
    ooc, ooc_steps, _, _ = admission_script(torch, eng, sources, s10, cut)
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "admission ooc")

    def script(rows):
        return [(r["active_queries"], r["admitted"], r["drained"],
                 r["retired"]) for r in rows]

    if not (same_bits(ooc.values, mem.values)
            and np.array_equal(ooc.per_query_supersteps,
                               mem.per_query_supersteps)
            and script(ooc_steps) == script(mem_steps)
            and all(r["fused_launches"] == num_tiles for r in ooc_steps)):
        raise AssertionError("admission: the out-of-core session differs "
                             "from the in-memory one")
    # the window holds the scheduled admission and, from 3 supersteps on,
    # the Q = 9 superstep and the drain at its barrier (the retirement and
    # admit() into the freed slot come a superstep later: checked in memory
    # by admission_phase)
    if not ([q] in [r["admitted"] for r in ooc_steps]
            and (cut < 3 or (
                any(r["active_queries"] == q + 1 for r in ooc_steps)
                and [DRAIN_QID] in [r["drained"] for r in ooc_steps]))):
        raise AssertionError(f"admission ooc: {script(ooc_steps)} misses a "
                             "step of the script")
    ooc_summary = vstate_summary(
        f"msbfs Q={q} then {q + 1} ooc (admission session)", ooc,
        steady_ms(mem), eng.vstate.stats.as_dict(), eng.vstate.num_intervals)
    if not sum(ooc_summary["spill_bytes"]):
        raise AssertionError("admission ooc: nothing spilled")
    log(f"admission: its first {cut} supersteps ((Q, admitted, drained, "
        f"retired) {script(ooc_steps)}) equal in memory and out of core bit "
        f"for bit")
    return ooc_summary, mem_steps, ooc_steps, launches


def free_port():
    """A TCP port on localhost that is free now (for a process group)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def load_tiles(store):
    plan = store.load_plan()
    ind, outd = store.load_degrees()
    return plan, [store.read_tile(t) for t in range(plan.num_tiles)], ind, outd


GLOO_APPS = ("pagerank", "msbfs")


def gloo_cuda_refusal(dev, world):
    """Why this torch's gloo refuses CUDA tensors in the collectives the
    broadcasts use (all_reduce SUM and MAX, all_gather), or None.  Only
    gloo's refusal by device type counts; any other error propagates."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device=dev)
    n = torch.ones(1, dtype=torch.int64, device=dev)
    i = torch.arange(4, dtype=torch.int32, device=dev)
    try:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        dist.all_gather([torch.empty_like(i) for _ in range(world)], i)
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    except RuntimeError as exc:
        if "unsupported device type" not in str(exc):
            raise
        return f"{type(exc).__name__}: {exc}"
    return None


def mesh_gloo_worker(rank, world, port, store_root, dev, sources, results):
    """One rank of the world-size-2 mesh on gloo, both ranks on the one
    card with CUDA tensors: PageRank (PR_SUPERSTEPS) and MultiSourceBFS at
    Q = 8 to convergence, both hybrid; the BFS's sparse supersteps launch
    compact.  Puts (rank, "ok" | "rejected" | "error", payload) on
    ``results``: "rejected" only where gloo refuses CUDA tensors by device
    type (``gloo_cuda_refusal``)."""
    import traceback

    import torch.distributed as dist

    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.distributed import (DistConfig,
                                              DistributedGABEngine,
                                              init_process_group)
    from repro_torch.graphio.formats import TileStore

    try:
        init_process_group(rank, world, f"tcp://localhost:{port}",
                           device=dev, backend="gloo")
        refusal = gloo_cuda_refusal(dev, world)
        if refusal is not None:
            results.put((rank, "rejected", refusal))
            return
        store = TileStore(store_root)
        store.load_meta()
        plan, tiles, ind, outd = load_tiles(store)
        runs = {}
        reset_launches()
        for app, prog, cap in (
                ("pagerank", PageRank(), PR_SUPERSTEPS),
                ("msbfs", MultiSourceBFS(sources=sources),
                 BFS_MAX_SUPERSTEPS)):
            t0 = time.perf_counter()
            vals, hist = DistributedGABEngine(None, DistConfig(
                device=dev)).run(prog, tiles, plan.num_vertices, outd, ind,
                                 plan.row_cap, max_supersteps=cap)
            runs[app] = dict(values=vals, history=hist,
                             seconds=time.perf_counter() - t0)
        results.put((rank, "ok", dict(runs=runs, launches=read_launches())))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_phase(torch, store, pr, msbfs, sources):
    """Phase 13: DistributedGABEngine at world size 1 on NCCL with all
    tiles resident: PageRank (PR_SUPERSTEPS) in dense, sparse and hybrid
    comm, MultiSourceBFS at Q = 8 in hybrid to convergence, each equal
    bit for bit to the tiled run; then world size 2 on gloo with CUDA
    tensors, both ranks on the one card (PageRank and MultiSourceBFS at
    Q = 8, hybrid, each equal to the tiled run bit for bit)."""
    import multiprocessing as mp
    import queue

    import torch.distributed as dist

    from repro_torch.core import comm
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.distributed import (DistConfig,
                                              DistributedGABEngine,
                                              init_process_group)

    plan, tiles, ind, outd = load_tiles(store)
    nv = plan.num_vertices
    backend = init_process_group(0, 1, f"tcp://localhost:{free_port()}",
                                 device=DEV)
    log(f"mesh: world size 1 on {backend}, {len(tiles)} tiles resident")
    rows = []
    launches = {}
    try:
        reset_launches()
        for app, prog, mode, want, cap in (
                [("pagerank", PageRank(), m, pr, PR_SUPERSTEPS)
                 for m in ("dense", "sparse", "hybrid")]
                + [("msbfs", MultiSourceBFS(sources=sources), "hybrid",
                    msbfs, BFS_MAX_SUPERSTEPS)]):
            eng = DistributedGABEngine(None, DistConfig(comm_mode=mode,
                                                        device=DEV))
            c0 = read_launches()["compact"]
            t0 = time.perf_counter()
            vals, hist = eng.run(prog, tiles, nv, outd, ind, plan.row_cap,
                                 max_supersteps=cap)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            compacts = read_launches()["compact"] - c0
            del eng
            torch.cuda.empty_cache()
            if not (same_bits(vals, want.values)
                    and len(hist) == want.supersteps):
                raise AssertionError(f"mesh {app} {mode}: differs from the "
                                     "tiled run")
            branches = [h["branch"] for h in hist]
            if mode == "sparse":
                # superstep 0 updates every vertex: the overflow guard
                # sends it dense on every rank
                cells = nv * getattr(prog, "num_queries", 1)
                cap_k = comm.sparse_capacity(cells)
                if not (hist[0]["density"] * cells > cap_k
                        and branches[0] == "dense"):
                    raise AssertionError(f"mesh sparse: the overflow guard "
                                         f"did not fire: {hist[0]}")
                if any((h["density"] * cells > cap_k) != (b == "dense")
                       for h, b in zip(hist, branches)):
                    raise AssertionError(f"mesh sparse: branches {branches}")
            step_s = [h["seconds"] for h in hist]
            rows.append(dict(app=app, mode=mode, supersteps=len(hist),
                             seconds=seconds,
                             per_superstep_ms=[1e3 * t for t in step_s],
                             steady_ms=1e3 * float(np.mean(
                                 step_s[1:] if len(step_s) > 1 else step_s)),
                             branches=branches,
                             density=[h["density"] for h in hist],
                             compact_launches=compacts))
            log(f"mesh {app} {mode}: {len(hist)} supersteps in {seconds:.1f} "
                f"s with the tiles' stacking and copy, "
                f"{rows[-1]['steady_ms']:.1f} ms a superstep steady, branches "
                f"{branches}, {compacts} compact launches; equal to the tiled "
                f"run bit for bit")
        launches["mesh"] = read_launches()
        require_launches(launches["mesh"], ("gab_fused", "compact"), "mesh")
    finally:
        dist.destroy_process_group()
    del tiles

    # world size 2 on gloo, CUDA tensors, both ranks on the one card
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=mesh_gloo_worker,
                         args=(r, 2, port, store.root, DEV, sources,
                               results),
                         daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + 300
    try:
        while len(got) < len(procs) and time.monotonic() < deadline:
            try:
                rank, status, payload = results.get(timeout=5)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break       # every rank exited; nothing more will come
                continue
            got[rank] = (status, payload)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: p for r, (st, p) in got.items() if st == "error"}
    if errors or len(got) != 2:
        raise AssertionError(f"mesh gloo world 2: {errors or got}")
    gloo = dict(status=sorted({st for st, _ in got.values()}))
    if "rejected" in gloo["status"]:
        gloo["rejected"] = {r: p for r, (st, p) in got.items()
                            if st == "rejected"}
        log(f"mesh gloo world 2: this torch's gloo rejects CUDA tensors in "
            f"a collective: {gloo['rejected']}")
    else:
        for app, want in zip(GLOO_APPS, (pr, msbfs)):
            for r, (_, p) in got.items():
                run = p["runs"][app]
                if not (same_bits(run["values"], want.values)
                        and len(run["history"]) == want.supersteps):
                    raise AssertionError(f"mesh gloo rank {r}: {app} differs "
                                         "from the tiled run")
            step_s = [h["seconds"] for h in got[0][1]["runs"][app]["history"]]
            gloo[app] = dict(
                seconds=[got[r][1]["runs"][app]["seconds"] for r in (0, 1)],
                branches=[h["branch"]
                          for h in got[0][1]["runs"][app]["history"]],
                per_superstep_ms=[1e3 * t for t in step_s],
                steady_ms=1e3 * float(np.mean(
                    step_s[1:] if len(step_s) > 1 else step_s)))
        launches["mesh gloo"] = {
            k: sum(got[r][1]["launches"][k] for r in (0, 1))
            for k in got[0][1]["launches"]}
        require_launches(launches["mesh gloo"], ("gab_fused", "compact"),
                         "mesh gloo")
        log(f"mesh gloo world 2 (CUDA tensors, one card): pagerank and msbfs "
            f"Q = {len(sources)} equal to the tiled runs bit for bit; "
            + ", ".join(f"{a} {gloo[a]['steady_ms']:.1f} ms a superstep "
                        f"steady, branches {gloo[a]['branches']}"
                        for a in GLOO_APPS))
    return dict(runs=rows, gloo_world2=gloo), launches


def cluster_phase(torch, store, pr, sources, s9):
    """Phase 14: run_cluster on the card at N = 2 and N = 4, shm
    transport, hybrid comm, one launch per N: PageRank and MultiSourceBFS
    at Q = 8 whose admit_plan brings s9 in after superstep 1, both capped
    at PR_SUPERSTEPS (one launch shares the engine's cap), each rank
    equal bit for bit to the single-process engine, the admitted column
    spliced at the same barrier on every rank."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.cluster import ClusterConfig, run_cluster

    plan = ((1, (s9,)),)
    q = len(sources)
    # one process for the batched app at the same cap (PageRank is phase
    # 5's tiled run): the cluster's N = 1
    t0 = time.perf_counter()
    single = engine(store, tile_skipping=False, admit_plan=plan).run(
        MultiSourceBFS(sources=sources), max_supersteps=PR_SUPERSTEPS)
    log(f"cluster reference (one process): msbfs {PR_SUPERSTEPS} "
        f"supersteps in {time.perf_counter() - t0:.1f} s, admitted "
        f"{[h.admitted_queries for h in single.history]}")
    if single.history[1].admitted_queries != (q,):
        raise AssertionError("cluster reference: the ninth query was not "
                             "admitted after superstep 1")
    out, launches = [], {}
    for n in (2, 4):
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        parent_used = total - free     # this process's share of the card
        ecfg = EngineConfig(seg_impl="fused", tile_skipping=False,
                            admit_plan=plan, max_supersteps=PR_SUPERSTEPS)
        progs = [PageRank(), MultiSourceBFS(sources=sources)]
        t0 = time.perf_counter()
        res = run_cluster(store.root, progs, ClusterConfig(
            num_servers=n, device=DEV, engine=ecfg,
            launch_timeout_seconds=600))
        wall = time.perf_counter() - t0
        for a, want in enumerate((pr, single)):
            for r in range(n):
                got = res.rank_results[r][a]

                def events(run):
                    return [(x.admitted_queries, x.retired_queries,
                             x.updated_vertices) for x in run.history]

                if not (same_bits(got.values, want.values)
                        and got.supersteps == want.supersteps
                        and (a == 0 or np.array_equal(
                            got.per_query_supersteps,
                            want.per_query_supersteps))
                        and events(got) == events(want)):
                    raise AssertionError(f"cluster N={n} rank {r} app {a}: "
                                         "differs from one process")
                if ([x.wire_bytes for x in got.history]
                        != [x.wire_bytes for x in
                            res.rank_results[0][a].history]):
                    raise AssertionError(f"cluster N={n} rank {r}: wire "
                                         "bytes differ from rank 0's")
        launches[f"cluster N={n}"] = {
            k: sum(rep["launches"][k] for rep in res.rank_reports)
            for k in res.rank_reports[0]["launches"]}
        require_launches(launches[f"cluster N={n}"], ("gab_fused",),
                         f"cluster N={n}")
        # the ranks report at their last barrier, all alive: what the card
        # holds beyond this process and the ranks' torch pools is their
        # CUDA contexts and hub scratch
        reps = res.rank_reports
        outside = (max(r["card_used_bytes"] for r in reps) - parent_used
                   - sum(r["torch_reserved_bytes"] for r in reps)) / n
        row = dict(n=n, wall_s=wall, reports=reps, apps=[],
                   parent_card_bytes=parent_used,
                   outside_torch_bytes_per_rank=outside)
        for a, name in enumerate(("pagerank", f"msbfs Q={q}+1")):
            res_a = res.results[a]
            row["apps"].append(dict(
                app=name, supersteps=res_a.supersteps,
                steady_ms=steady_ms(res_a),
                per_superstep_ms=[1e3 * x.seconds for x in res_a.history],
                wire_bytes=[x.wire_bytes for x in res_a.history],
                raw_bytes=[x.raw_bytes for x in res_a.history],
                admitted=[list(x.admitted_queries) for x in res_a.history],
                exchange_seconds=[rep["exchange_seconds"][a]
                                  for rep in res.rank_reports]))
            ex = res.rank_reports[0]["exchange_seconds"][a]
            log(f"cluster N={n} {name}: {res_a.supersteps} supersteps, "
                f"{steady_ms(res_a):.1f} ms a superstep steady, wire "
                f"{[x.wire_bytes for x in res_a.history]} B; rank 0 "
                f"exchange " + ", ".join(f"{k.removeprefix('exchange_')} "
                                         f"{v:.2f} s" for k, v in ex.items()))
        for rep in res.rank_reports:
            log(f"  rank {rep['rank']} on {rep['device']}: {rep['seconds']:.1f}"
                f" s, sent {rep['wire_bytes']} B, launches {rep['launches']}, "
                f"torch reserved {rep.get('torch_reserved_bytes')} B, card "
                f"in use {rep.get('card_used_bytes')} B")
        log(f"cluster N={n}: {outside / 2**20:.0f} MiB a rank outside torch's "
            f"allocator (context, hub scratch; this process held "
            f"{parent_used / 2**20:.0f} MiB of the card)")
        log(f"cluster N={n}: {wall:.1f} s for the launch; every rank equal "
            f"to one process bit for bit, the admitted column spliced after "
            f"superstep 1 on every rank")
        out.append(row)
    return dict(single_msbfs=app_summary(f"msbfs Q={q}+1 one process",
                                         single),
                runs=out), launches, single


def checkpoint_files(d):
    """(bytes written, bytes hardlinked, blocks written, blocks hardlinked)
    of one published checkpoint directory: a file with more than one link
    is shared with the checkpoint before it."""
    out = [0, 0, 0, 0]
    for dirpath, _dirs, files in os.walk(d):
        for fn in files:
            st = os.stat(os.path.join(dirpath, fn))
            linked = st.st_nlink > 1
            out[1 if linked else 0] += st.st_size
            if fn.endswith(".blk"):
                out[3 if linked else 2] += 1
    return out


def timed_checkpointer(ckpt, saves, loads):
    """Time every save and load of a GraphCheckpointer (the engine's) and
    record each published checkpoint's bytes and blocks."""
    save, load = ckpt.save_graph, ckpt.load_graph

    def save_graph(superstep, *args, **kw):
        t0 = time.perf_counter()
        d = save(superstep, *args, **kw)
        dt = time.perf_counter() - t0
        w, lk, bw, bl = checkpoint_files(d)
        saves.append(dict(step=superstep, seconds=dt, bytes_written=w,
                          bytes_linked=lk, blocks_written=bw,
                          blocks_linked=bl))
        log(f"  checkpoint step {superstep}: {dt:.3f} s, {w} bytes written, "
            f"{lk} hardlinked; blocks {bw} written, {bl} hardlinked")
        return d

    def load_graph(*args, **kw):
        t0 = time.perf_counter()
        got = load(*args, **kw)
        loads.append(dict(step=None if got is None else got.step,
                          seconds=time.perf_counter() - t0))
        log(f"  checkpoint load of step {loads[-1]['step']}: "
            f"{loads[-1]['seconds']:.3f} s")
        return got

    ckpt.save_graph, ckpt.load_graph = save_graph, load_graph


def block_codec(d):
    """The codec of the interval blocks under checkpoint dir ``d``, sniffed
    from their first bytes (zstd's frame magic or zlib's header)."""
    heads = set()
    for p in sorted(glob.glob(os.path.join(d, "step_*", "blocks", "*.blk"))):
        with open(p, "rb") as f:
            head = f.read(4)
        heads.add("zstd" if head == b"\x28\xb5\x2f\xfd" else
                  "zlib" if head[:1] == b"\x78" else "other")
    return sorted(heads)


def crash_and_resume(make, prog, expect, what, max_supersteps):
    """Run ``make(resume=False)``'s engine until the fault it is armed with
    ends it (``expect`` is the exception that must come, anything else is
    re-raised), then a fresh ``make(resume=True)`` engine to the end.
    Returns (the exception, the resumed result, save rows, load rows)."""
    saves, loads = [], []
    eng = make(resume=False)
    timed_checkpointer(eng.ckpt, saves, loads)
    try:
        eng.run(prog(), max_supersteps=max_supersteps)
    except expect as e:
        caught = e
    else:
        raise AssertionError(f"{what}: the injected fault did not come")
    log(f"{what}: {type(caught).__name__}: {caught}")
    eng = make(resume=True)
    timed_checkpointer(eng.ckpt, saves, loads)
    res = eng.run(prog(), max_supersteps=max_supersteps)
    return caught, res, saves, loads


def checkpoint_engine(store, d, spec, resume, **kw):
    """An engine checkpointing every boundary into ``d``, armed with the
    fault ``spec`` unless it resumes."""
    from repro_torch.runtime.faults import FaultPlan

    return engine(store, tile_skipping=False, checkpoint_dir=d,
                  checkpoint_every=1, resume=resume,
                  fault_plan=None if resume else FaultPlan(specs=(spec,)),
                  **kw)


def checkpoint_ooc(torch, store_root, ckpt_root):
    """Phase 15 (c), in a side process: out-of-core PageRank at
    OOC_PR_BUDGET, OOC_CKPT_SUPERSTEPS supersteps, crashed at
    OOC_CKPT_CRASH_SS and resumed, its checkpoints interval blocks (the
    second hardlinking the unchanged ones), equal to the in-memory run."""
    from repro_torch import compat
    from repro_torch.core.apps import PageRank
    from repro_torch.runtime.faults import FaultSpec, InjectedFault

    store = open_store(store_root)
    d = os.path.join(ckpt_root, "pagerank_ooc")
    spec = FaultSpec(site="superstep", superstep=OOC_CKPT_CRASH_SS,
                     kind="raise")
    mem = engine(store, tile_skipping=False).run(
        PageRank(), max_supersteps=OOC_CKPT_SUPERSTEPS)
    reset_launches()
    t0 = time.perf_counter()
    _e, res, saves, loads = crash_and_resume(
        lambda resume: checkpoint_engine(store, d, spec, resume,
                                         num_intervals=OOC_INTERVALS,
                                         vertex_memory_budget=OOC_PR_BUDGET),
        PageRank, InjectedFault, "checkpoint pagerank ooc",
        OOC_CKPT_SUPERSTEPS)
    wall = time.perf_counter() - t0
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "checkpoint ooc")
    codec = block_codec(d)
    want_codec = ["zstd"] if compat.HAVE_ZSTD else ["zlib"]
    boundaries = [r for r in saves if r["step"] <= OOC_CKPT_SUPERSTEPS]
    if not (same_bits(res.values, mem.values)
            and res.supersteps == OOC_CKPT_SUPERSTEPS
            and len(res.history) == OOC_CKPT_SUPERSTEPS - OOC_CKPT_CRASH_SS):
        raise AssertionError("checkpoint ooc: the resumed out-of-core run "
                             "differs from the in-memory one")
    if not (boundaries and all(r["blocks_written"] for r in boundaries)
            and boundaries[-1]["blocks_linked"] and codec == want_codec):
        raise AssertionError(f"checkpoint ooc: blocks {boundaries}, codec "
                             f"{codec}")
    out = dict(wall_s=wall, saves=saves, loads=loads, codec=codec,
               resumed=app_summary("pagerank ooc resumed", res))
    log(f"checkpoint pagerank ooc: {OOC_CKPT_SUPERSTEPS} supersteps, crash "
        f"at {OOC_CKPT_CRASH_SS}, interval blocks {codec}, equal to the "
        f"in-memory run bit for bit ({wall:.1f} s)")
    return out, launches


def checkpoint_phase(torch, store, pr, single, sources, s9, ckpt_root,
                     ooc_part):
    """Phase 15: superstep checkpoints, crash and preemption resume and a
    supervised cluster shrink on the card, each part equal bit for bit to
    its uninterrupted run and each launching gab_fused.  Part c
    (checkpoint_ooc) ran in a side process: ``ooc_part`` is its result."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.partition import assign_tiles
    from repro_torch.launch.cluster import ClusterConfig, run_cluster
    from repro_torch.runtime.elastic import remap_assignment
    from repro_torch.runtime.faults import FaultPlan, FaultSpec, InjectedFault
    from repro_torch.runtime.ft import Preempted

    out, launches = {}, {}
    plan = store.load_plan()

    def ckpt_engine(d, spec, resume, **kw):
        return checkpoint_engine(store, d, spec, resume, **kw)

    # a: crash and resume in one process, PageRank tiled
    d = os.path.join(ckpt_root, "pagerank")
    spec = FaultSpec(site="superstep", superstep=CKPT_CRASH_SS, kind="raise")
    reset_launches()
    t0 = time.perf_counter()
    _e, res, saves, loads = crash_and_resume(
        lambda resume: ckpt_engine(d, spec, resume), PageRank, InjectedFault,
        "checkpoint pagerank", PR_SUPERSTEPS)
    wall = time.perf_counter() - t0
    if not (same_bits(res.values, pr.values)
            and res.supersteps == PR_SUPERSTEPS
            and len(res.history) == PR_SUPERSTEPS - CKPT_CRASH_SS):
        raise AssertionError("checkpoint: the resumed PageRank differs from "
                             "the uninterrupted run")
    part_a = read_launches()
    require_launches(part_a, ("gab_fused",), "checkpoint pagerank")
    out["pagerank"] = dict(wall_s=wall, saves=saves, loads=loads,
                           resumed=app_summary("pagerank resumed", res))
    log(f"checkpoint pagerank: crash at superstep {CKPT_CRASH_SS}, resumed "
        f"from boundary {loads[-1]['step']}, equal to phase 5 bit for bit "
        f"({wall:.1f} s)")

    # b: preemption with a scheduled admission, MultiSourceBFS Q = 8 -> 9
    d = os.path.join(ckpt_root, "msbfs")
    spec = FaultSpec(site="barrier", superstep=CKPT_PREEMPT_SS,
                     kind="preempt")
    reset_launches()
    t0 = time.perf_counter()
    caught, res, saves, loads = crash_and_resume(
        lambda resume: ckpt_engine(d, spec, resume, preemptible=not resume,
                                   admit_plan=((1, (s9,)),)),
        lambda: MultiSourceBFS(sources=sources), Preempted,
        "checkpoint msbfs", PR_SUPERSTEPS)
    wall = time.perf_counter() - t0
    if caught.superstep != CKPT_PREEMPT_SS + 1:
        raise AssertionError(f"checkpoint: preempted at {caught.superstep}")
    if not (same_bits(res.values, single.values)
            and res.supersteps == PR_SUPERSTEPS
            and np.array_equal(res.per_query_supersteps,
                               single.per_query_supersteps)):
        raise AssertionError("checkpoint: the resumed MultiSourceBFS "
                             "differs from phase 14's one-process run")
    part_b = read_launches()
    require_launches(part_b, ("gab_fused",), "checkpoint msbfs")
    launches["checkpoint"] = {k: part_a[k] + part_b[k] for k in part_a}
    out["msbfs"] = dict(wall_s=wall, saves=saves, loads=loads,
                        preempted_at=caught.superstep,
                        resumed=app_summary(f"msbfs Q={len(sources)}+1 "
                                            "resumed", res))
    log(f"checkpoint msbfs: preempted at boundary {caught.superstep}, the "
        f"resume equals phase 14's one-process run bit for bit "
        f"({wall:.1f} s)")

    # c: out of core, interval blocks (checkpoint_ooc, a side process)
    out["pagerank_ooc"], launches["checkpoint ooc"] = ooc_part

    # d: supervised shrink of a spawned cluster on the card
    d = os.path.join(ckpt_root, "cluster")
    markers = os.path.join(ckpt_root, "cluster_markers")
    kill_ss, kill_rank = SHRINK_KILL
    ecfg = EngineConfig(
        seg_impl="fused", tile_skipping=False, max_supersteps=PR_SUPERSTEPS,
        checkpoint_dir=d, checkpoint_every=1,
        checkpoint_keep=PR_SUPERSTEPS + 2,
        fault_plan=FaultPlan(specs=(FaultSpec(
            site="barrier", superstep=kill_ss, rank=kill_rank,
            kind="kill"),), marker_dir=markers))
    reset_launches()       # the ranks count in their processes and report
    t0 = time.perf_counter()
    res = run_cluster(store.root, [PageRank()], ClusterConfig(
        num_servers=SHRINK_FROM, device=DEV, on_failure="shrink",
        engine=ecfg, launch_timeout_seconds=600))
    wall = time.perf_counter() - t0
    want_asg = remap_assignment(assign_tiles(plan.num_tiles, SHRINK_FROM),
                                SHRINK_FROM - 1, plan.edges_per_tile)
    got = res.results[0]
    if not (res.verified and res.restarts == 1
            and res.final_servers == SHRINK_FROM - 1
            and len(res.rank_reports) == SHRINK_FROM - 1
            and all(r["final_assignment"] == want_asg
                    for r in res.rank_reports)
            and same_bits(got.values, pr.values)
            and got.supersteps == PR_SUPERSTEPS):
        raise AssertionError("cluster restart: the shrunk cluster differs "
                             "from one process")
    launches["cluster restart"] = {
        k: sum(rep["launches"][k] for rep in res.rank_reports)
        for k in res.rank_reports[0]["launches"]}
    require_launches(launches["cluster restart"], ("gab_fused",),
                     "cluster restart")
    # the kill's time is its once-marker's (claimed just before the
    # os._exit); the new attempt's first superstep ends with rank 0's
    # first boundary checkpoint, the one after the boundary it resumed from
    (marker,) = glob.glob(os.path.join(markers, "*.fired"))
    killed_at = os.stat(marker).st_mtime
    resumed_from = PR_SUPERSTEPS - len(got.history)
    meta = os.path.join(d, "prog_00", f"step_{resumed_from + 1:08d}",
                        "meta.json")
    respawn_s = os.stat(meta).st_mtime - killed_at
    out["cluster"] = dict(
        wall_s=wall, restarts=res.restarts, final_servers=res.final_servers,
        resumed_from=resumed_from, kill_to_first_superstep_s=respawn_s,
        assignment=want_asg, reports=res.rank_reports,
        resumed=app_summary("pagerank cluster resumed", got))
    log(f"cluster restart: rank {kill_rank} of {SHRINK_FROM} killed at the "
        f"barrier of superstep {kill_ss}; 1 restart on "
        f"{SHRINK_FROM - 1} ranks (remapped assignment) from boundary "
        f"{resumed_from}; kill to the new attempt's first superstep "
        f"{respawn_s:.1f} s; rank 0 equal to one process bit for bit "
        f"({wall:.1f} s)")
    for rep in res.rank_reports:
        log(f"  rank {rep['rank']}: {rep['seconds']:.1f} s, "
            f"{len(rep['final_assignment'][rep['rank']])} tiles, launches "
            f"{rep['launches']}")
    return out, launches


def http_call(url, body=None, timeout=60):
    """One JSON request (POST when ``body`` is given, else GET); returns
    (status, Retry-After header or None, decoded JSON body)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Retry-After"), json.loads(
                r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def serve_clients(base, queries):
    """One client thread a query: POST it, then poll its rid until the
    ticket is terminal.  Returns the terminal tickets, in order."""
    import threading

    out, errors = [None] * len(queries), []

    def client(i, body):
        try:
            code, _, posted = http_call(base + "/v1/query", body)
            if code != 200:
                raise AssertionError(f"POST {body}: {code} {posted}")
            deadline = time.monotonic() + SERVE_CLIENT_TIMEOUT_S
            while time.monotonic() < deadline:
                code, _, t = http_call(f"{base}/v1/query/{posted['rid']}")
                if code != 200:
                    raise AssertionError(f"GET {posted['rid']}: {code} {t}")
                if t["status"] in ("done", "timeout", "failed"):
                    out[i] = t
                    return
                time.sleep(SERVE_POLL_S)
            raise AssertionError(f"rid {posted['rid']} never finished")
        except Exception as e:  # surfaced below, in the caller's thread
            errors.append((body, e))

    threads = [threading.Thread(target=client, args=(i, body))
               for i, body in enumerate(queries)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(SERVE_CLIENT_TIMEOUT_S + 60)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serve clients failed: {errors}")
    return out


def pick_serve_seeds(out_degree, sources, s9, s10):
    """SERVE_LANDMARKS landmark seeds drawn from SEED among the vertices
    with out-degree > 0 that no earlier phase used, and the deadline
    query's source: the vertex of largest out-degree among those left
    (its BFS runs several supersteps, so a drain leaves a partial
    column)."""
    rng = np.random.default_rng(SEED + 16)
    used = np.asarray(list(sources) + [s9, s10])
    cand = np.setdiff1d(np.nonzero(out_degree > 0)[0], used)
    landmarks = tuple(int(v) for v in rng.choice(cand, SERVE_LANDMARKS,
                                                 replace=False))
    left = np.setdiff1d(cand, np.asarray(landmarks))
    return landmarks, int(left[np.argmax(out_degree[left])])


def serve_phase(torch, store, src, dst, sources, msbfs, levels, s9, s10):
    """Phase 16: the online query service on the card behind its HTTP
    frontend.  GraphService over the store (device cuda, the fused
    kernel, tile skipping off, q_slots 8, min_fill 4, max_wait 50 ms,
    tenants alice:3 and bob:1, a result cache of 64 entries) fronted by
    HttpFrontend on 127.0.0.1:0; client threads POST and poll.  Wave 1:
    MultiSourceBFS from the eight batched sources and LandmarkDistances
    from two new seeds; wave 2: LandmarkDistances from two more and one
    MultiSourceBFS query with a SERVE_DEADLINE_MS deadline, drained as
    ``timeout``; wave 3: repeats of finished seeds, which come back as
    cache hits with no slot used.  Every done column, decoded from its
    HTTP body, equals the reference BFS levels, and the sources' columns equal
    phase 8's direct batched run bit for bit with equal per-query
    supersteps.  Then the drain: /healthz and POST answer 503 with
    Retry-After, and GET still answers for every rid.  The launch counts
    are read around the service's life ("serve"); the Q of every fused
    launch is recorded, and the fused kernel is held to its plain version
    at each (program, Q) the service launched it at."""
    from repro_torch.core.apps import LandmarkDistances, MultiSourceBFS
    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels import gab_fused
    from repro_torch.serve.graph_service import GraphService
    from repro_torch.serve.http import HttpFrontend, decode_array

    nv = store.load_plan().num_vertices
    out_degree = store.load_degrees()[1]
    landmarks, late = pick_serve_seeds(out_degree, sources, s9, s10)
    t0 = time.perf_counter()
    lm_levels = ref_bfs(torch, src, dst, nv, landmarks + (late,))
    log(f"serve: landmarks {landmarks}, deadline source {late} "
        f"(reference BFS {time.perf_counter() - t0:.1f} s)")
    want = {("msbfs", s): levels[:, q] for q, s in enumerate(sources)}
    want.update({("landmarks", s): lm_levels[:, i]
                 for i, s in enumerate(landmarks)})
    depth = {q: int(levels[np.isfinite(levels[:, q]), q].max())
             for q in range(len(sources))}
    # per-query supersteps of a BFS column against its depth, from the
    # direct run; every served BFS-like column must keep the same offset
    offsets = {int(msbfs.per_query_supersteps[q]) - depth[q] for q in depth}
    if len(offsets) != 1:
        raise AssertionError(f"serve: supersteps - depth not one value: "
                             f"{offsets}")
    offset = offsets.pop()

    closed = []

    class MeasuredService(GraphService):
        """The service, logging the device's memory after each closed
        session (on the serve thread, after the session released its
        state)."""

        def _close_session(self, app, sess):
            super()._close_session(app, sess)
            torch.cuda.synchronize()
            closed.append(dict(
                app=app, supersteps=sess.superstep,
                allocated=torch.cuda.memory_allocated(),
                reserved=torch.cuda.memory_reserved(),
                non_torch=non_torch_device_bytes(torch)))

    specs = {MultiSourceBFS().fused_spec(): "msbfs",
             LandmarkDistances().fused_spec(): "landmarks"}
    fused_q = {}
    kernel = gab_fused.gab_fused

    def recording(spec, src_vals, *args, **kw):
        key = (specs.get(spec, str(spec)),
               1 if src_vals.ndim == 1 else int(src_vals.shape[1]))
        fused_q[key] = fused_q.get(key, 0) + 1
        return kernel(spec, src_vals, *args, **kw)

    cfg = EngineConfig(num_servers=1, device=DEV, seg_impl="fused",
                       tile_skipping=False)
    svc = MeasuredService(store, cfg, q_slots=SERVE_Q_SLOTS,
                          min_fill=SERVE_MIN_FILL,
                          max_wait_s=SERVE_MAX_WAIT_S,
                          tenants=SERVE_TENANTS,
                          result_cache=SERVE_CACHE)
    fe = HttpFrontend(svc, host="127.0.0.1", port=0).start()
    base = fe.address
    tenants = sorted(SERVE_TENANTS)
    torch.cuda.synchronize()
    mem0 = dict(allocated=torch.cuda.memory_allocated(),
                reserved=torch.cuda.memory_reserved(),
                non_torch=non_torch_device_bytes(torch))
    log(f"serve: {svc.cfg.device}, frontend {base}; before: {mem0}")
    gab_fused.gab_fused = recording
    try:
        reset_launches()
        t_serve = time.perf_counter()
        svc.start()
        wave1 = serve_clients(base, [
            dict(app="msbfs", seed=s, tenant=tenants[i % 2])
            for i, s in enumerate(sources)] + [
            dict(app="landmarks", seed=s, tenant=tenants[i % 2])
            for i, s in enumerate(landmarks[:2])])
        wave2 = serve_clients(base, [
            dict(app="landmarks", seed=s, tenant=tenants[i % 2])
            for i, s in enumerate(landmarks[2:])] + [
            dict(app="msbfs", seed=late, tenant=tenants[0],
                 deadline_ms=SERVE_DEADLINE_MS)])
        before_hits = svc.stats_snapshot()
        wave3 = serve_clients(base, [
            dict(app="msbfs", seed=sources[0], tenant=tenants[0]),
            dict(app="msbfs", seed=sources[1], tenant=tenants[1]),
            dict(app="landmarks", seed=landmarks[0], tenant=tenants[0])])
        after_hits = svc.stats_snapshot()
        svc.request_drain()
        svc.join(600)
        serve_s = time.perf_counter() - t_serve
        launches = read_launches()
    finally:
        gab_fused.gab_fused = kernel
    if svc._thread.is_alive():
        raise AssertionError("serve: the serve thread did not drain")
    require_launches(launches, ("gab_fused",), "serve")

    # the drain: healthz and POST refuse with Retry-After, GET answers
    code, retry, _ = http_call(base + "/healthz")
    pcode, pretry, _ = http_call(base + "/v1/query",
                                 dict(app="msbfs", seed=sources[0]))
    if (code, retry, pcode, pretry) != (503, "1", 503, "1"):
        raise AssertionError(f"serve: drained /healthz {code} {retry}, "
                             f"POST {pcode} {pretry}")
    for t in wave1 + wave2 + wave3:
        code, _, again = http_call(f"{base}/v1/query/{t['rid']}")
        if code != 200 or again["status"] != t["status"]:
            raise AssertionError(f"serve: GET {t['rid']} after the drain: "
                                 f"{code} {again.get('status')}")
    snap = svc.stats_snapshot()
    http_counts = fe.counters()
    fe.close()
    stats = snap["stats"]
    if stats["submitted"] != (stats["done"] + stats["timeout"]
                              + stats["failed"] + stats["refused"]):
        raise AssertionError(f"serve: counters do not add up: {stats}")

    # every done column against the reference, the sources' against phase 8's run
    for t in wave1 + wave2[:-1]:
        col = decode_array(t["result"])
        key = (t["app"], t["seed"])
        if t["status"] != "done" or t["cache_hit"]:
            raise AssertionError(f"serve: {key} ended {t['status']}")
        if not same_bits(col, want[key]):
            raise AssertionError(f"serve: {key} differs from the reference "
                                 "BFS")
        d = int(want[key][np.isfinite(want[key])].max())
        if t["supersteps"] != d + offset:
            raise AssertionError(f"serve: {key} took {t['supersteps']} "
                                 f"supersteps, its depth {d}")
        if t["app"] == "msbfs":
            q = sources.index(t["seed"])
            if not (same_bits(col, msbfs.values[:, q])
                    and t["supersteps"] == msbfs.per_query_supersteps[q]):
                raise AssertionError(f"serve: {key} differs from the "
                                     "direct batched run")
    # the deadline query: drained with a partial column, never cached
    dl = wave2[-1]
    part = decode_array(dl["result"])
    lv = lm_levels[:, -1]
    k = int(part[np.isfinite(part)].max())
    if not (dl["status"] == "timeout" and dl["supersteps"] == -1
            and k < int(lv[np.isfinite(lv)].max())
            and same_bits(part, np.where(lv <= k, lv,
                                         np.float32(np.inf)))):
        raise AssertionError(f"serve: the deadline query ended "
                             f"{dl['status']}, not a partial BFS")
    with svc.cache._lock:
        if ("msbfs", late, svc.fingerprint) in svc.cache._entries:
            raise AssertionError("serve: a timeout column was cached")
    # the repeats: cache hits, equal bytes, no slot, no superstep
    firsts = {(t["app"], t["seed"]): t for t in wave1}
    for t in wave3:
        orig = firsts[(t["app"], t["seed"])]
        if not (t["status"] == "done" and t["cache_hit"]
                and t["supersteps"] == orig["supersteps"]
                and t["result"] == orig["result"]):
            raise AssertionError(f"serve: repeat {t['app']} {t['seed']} is "
                                 "not a cache hit of its first answer")
    b, a = before_hits, after_hits
    if not (a["stats"]["sessions_opened"] == b["stats"]["sessions_opened"]
            and a["stats"]["supersteps"] == b["stats"]["supersteps"]
            and a["stats"]["cache_hits"] == b["stats"]["cache_hits"] + 3
            and all(a["tenants"][n]["admitted"]
                    == b["tenants"][n]["admitted"] for n in tenants)):
        raise AssertionError(f"serve: cache hits used a slot: {b} -> {a}")

    lat = svc.latency_summary()
    qps = stats["done"] / serve_s
    log(f"serve: {stats['done']} done ({stats['cache_hits']} cache hits), "
        f"{stats['timeout']} timeout, {stats['refused']} refused in "
        f"{serve_s:.1f} s: {qps:.3f} queries/s, {stats['supersteps']} "
        f"supersteps, {stats['sessions_opened']} sessions; latency p50 "
        f"{lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms, mean queue "
        f"{lat['mean_queue_ms']:.1f} ms + service {lat['mean_service_ms']:.1f}"
        f" ms; tenants {snap['tenants']}; http {http_counts}")
    log(f"serve: fused launches by (program, Q): "
        f"{dict(sorted(fused_q.items()))}")
    for row in closed:
        log(f"serve: closed a {row['app']} session after {row['supersteps']}"
            f" supersteps: torch allocated {row['allocated']}, reserved "
            f"{row['reserved']}, outside torch {row['non_torch']} bytes")
    if sum(fused_q.values()) != launches["gab_fused"]:
        raise AssertionError(f"serve: {sum(fused_q.values())} fused calls "
                             f"recorded, {launches['gab_fused']} counted")

    rows = check_serve_shapes(torch, store, fused_q)
    return dict(landmarks=list(landmarks), deadline_source=late,
                seconds=serve_s, queries_per_s=qps, stats=stats,
                tenants=snap["tenants"], cache=snap["cache"],
                http=http_counts, latency=lat, memory_before=mem0,
                closed_sessions=closed,
                fused_launches_by_q=[[app, q, n] for (app, q), n
                                     in sorted(fused_q.items())],
                kernel_cases=rows), {"serve": launches}


def check_serve_shapes(torch, store, fused_q):
    """The fused kernel at each (program, Q) the service launched it at,
    on the largest tile, against its plain version and the merged-mode
    composition (as phase 4), with the batched programs themselves."""
    from repro_torch.core.apps import LandmarkDistances, MultiSourceBFS

    plan = store.load_plan()
    tile = store.read_tile(int(np.argmax(plan.edges_per_tile)))
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    dst = torch.from_numpy(tile.dst_local).to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    progs = {"msbfs": MultiSourceBFS(), "landmarks": LandmarkDistances()}
    rows = []
    for app, q in sorted(fused_q):
        case = fused_inputs(torch, progs[app], dst, tile.meta.num_rows,
                            plan.row_cap, q, gen)
        row = check_fused_case(torch, case, flush, f"serve shape: fused "
                               f"{app} Q={q}")
        rows.append(dict(spec=app, launches=fused_q[(app, q)], **row))
    del flush
    torch.cuda.empty_cache()
    return rows


TUNE_FUSED = (("pagerank", 1), ("pagerank", 8), ("bfs", 1), ("bfs", 8),
              ("bfs", 9), ("landmarks", 2), ("landmarks", 8))
TUNE_SEGMENT_Q = (1, 8)


def calibrate_tuner(torch, flush, tile, plan):
    """Phase 17a: roofline/hw.py's measured figures, measured again and
    logged beside the table's (the tuner reads the table, never this):
    launch_s, the device time of a fused call over 32 edges and rows (a
    launch and one row block); host_call_s, the host time of such a
    call (wall time of 2,000 back to back); stack_dispatch_s, the host
    time of gab.run_tile_stack over one such tile beyond the call
    inside it; row_wave_s, a wave of row blocks beyond its bytes (the
    segment sum over 2^20 rows of one edge each, at each block_r); hub_s,
    a hub beyond its bytes (the segment sum over 2^20 edges in rows of
    513 edges, every row a hub at H = 256, ceil(hubs / 512) hubs a
    group); edge_warp_s, an edge of the longest row the row launch keeps
    (the slope of the fused BFS kernel's time at Q = 1 and 256 rows a
    block on the largest tile from H = 256 to 2048: 4,095 - 511 more
    edges); hub_share, the largest tile's hubs at H = 256 over the most
    its edge list can hold (E / 2H)."""
    from repro_torch.core import apps
    from repro_torch.core.gab import run_tile_stack
    from repro_torch.kernels import gab_fused, gab_gather
    from repro_torch.kernels.blocks import BLOCK_R
    from repro_torch.roofline import hw, kernel_tune

    dev = torch.device(DEV)
    spec = apps.BFS().fused_spec()
    n = 32
    d32 = torch.arange(n, dtype=torch.int32, device=dev)
    s32 = torch.rand(n, device=dev)
    o32 = torch.rand(n, device=dev)

    def tiny():
        return gab_fused.gab_fused(spec, s32, None, None, d32, o32, None,
                                   n, n)

    launch_ms = time_ms(torch, tiny, flush, reps=50)
    reps = 2000
    tiny()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tiny()
    torch.cuda.synchronize()
    host_call_s = (time.perf_counter() - t0) / reps
    values = torch.rand(4096, device=dev)
    stk = dict(src=np.arange(n, dtype=np.int32)[None],
               dst_local=np.arange(n, dtype=np.int32)[None],
               val=np.ones((1, n), np.float32), row_start=np.zeros(1, int),
               num_rows=np.full(1, n))
    prog = apps.BFS()
    run_tile_stack(prog, values, {}, stk, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps // 4):
        run_tile_stack(prog, values, {}, stk, n)
    torch.cuda.synchronize()
    stack_s = (time.perf_counter() - t0) / (reps // 4) - host_call_s

    e = 1 << 20
    ones = torch.rand(e, device=dev)
    d1 = torch.arange(e, dtype=torch.int32, device=dev)
    wave_s = {}
    for br in BLOCK_R:
        t = time_ms(torch, lambda: gab_gather.segment_reduce(
            ones, d1, e, "sum", blocks=(256, br)), flush) / 1e3
        waves = -(-(-(-e // br)) // (hw.SMS * kernel_tune.blocks_per_sm(br)))
        wave_s[br] = (t - e * 12 / hw.HBM_BW) / waves
    hub_len = 2 * 256 + 1
    hubs = e // hub_len
    dh = torch.arange(hubs, dtype=torch.int32,
                      device=dev).repeat_interleave(hub_len).contiguous()
    ch = torch.rand(dh.shape[0], device=dev)
    t = time_ms(torch, lambda: gab_gather.segment_reduce(
        ch, dh, hubs, "sum", blocks=(256, 256)), flush) / 1e3
    groups = min((dh.shape[0] - 1) // 256, kernel_tune.HUB_GROUPS_MAX)
    hub_s = (t - dh.shape[0] * 8 / hw.HBM_BW) / -(-hubs // groups)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    dtile = torch.from_numpy(tile.dst_local).to(dev)
    args, _ = fused_inputs(torch, apps.BFS(), dtile, tile.meta.num_rows,
                           plan.row_cap, 1, gen)
    t_h = {h: time_ms(torch, lambda h=h: gab_fused.gab_fused(
        *args, blocks=(h, 256)), flush) / 1e3 for h in (256, 2048)}
    edge_warp_s = (t_h[2048] - t_h[256]) / ((2 * 2048 - 1) - (2 * 256 - 1))
    d = tile.dst_local.astype(np.int64)
    m = np.arange((len(d) - 1) // 256) * 256
    r = d[m]
    hub = ((r < tile.meta.num_rows) & (d[m + 256] == r)
           & ((m == 0) | (d[np.maximum(m - 256, 0)] != r)))
    hub_share = float(hub.sum()) / (len(d) / (2 * 256))
    out = dict(launch_s=launch_ms / 1e3, host_call_s=host_call_s,
               edge_warp_s=edge_warp_s, hub_share=hub_share,
               stack_dispatch_s=stack_s, row_wave_s=wave_s,
               row_wave_s_mean=float(np.mean(list(wave_s.values()))),
               hub_s=hub_s,
               table=dict(launch_s=hw.LAUNCH_S,
                          stack_dispatch_s=hw.STACK_DISPATCH_S,
                          row_wave_s=hw.ROW_WAVE_S, hub_s=hw.HUB_S,
                          edge_warp_s=hw.EDGE_WARP_S,
                          hub_share=hw.HUB_SHARE,
                          measured_on=hw.MEASURED_ON))
    log(f"tuner calibration: launch {out['launch_s'] * 1e6:.2f} us (table "
        f"{hw.LAUNCH_S * 1e6:.2f}), host call {host_call_s * 1e6:.2f} us, "
        f"stack dispatch {stack_s * 1e6:.2f} us (table "
        f"{hw.STACK_DISPATCH_S * 1e6:.2f}), row wave "
        + ", ".join(f"{k}: {v * 1e6:.2f}" for k, v in wave_s.items())
        + f" us (table {hw.ROW_WAVE_S * 1e6:.2f}), hub {hub_s * 1e6:.2f} us "
        f"(table {hw.HUB_S * 1e6:.2f}; {hubs} hubs, {groups} groups), edge "
        f"of the longest kept row {edge_warp_s * 1e9:.2f} ns (table "
        f"{hw.EDGE_WARP_S * 1e9:.2f}), hub share {hub_share:.4f} (table "
        f"{hw.HUB_SHARE:.4f}; {int(hub.sum())} hubs at H = 256)")
    return out


def tune_candidates(torch, tile, plan, flush):
    """Phase 17b: at the largest tile's shape, every legal (block_e,
    block_r) of the fused kernel (PageRank, BFS and landmarks specs at
    the Q's the paths launch) and of the segment sum (Q = 1 and 8, into
    row_cap + 1 rows): new and updated (out) equal to the default blocks'
    bit for bit, each timed as phase 4 times, beside the tuner's
    prediction; per case the pick's time over the best time.  Returns
    (the per-case rows, the kernels line's tuned entries' rows)."""
    from repro_torch.core import apps
    from repro_torch.kernels import gab_fused, gab_gather, ref
    from repro_torch.kernels.blocks import BLOCK_E, BLOCK_R, DEFAULT_BLOCKS
    from repro_torch.roofline import kernel_tune

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    dst = torch.from_numpy(tile.dst_local).to(dev)
    nr, r, e = tile.meta.num_rows, plan.row_cap, plan.edge_cap
    progs = {"pagerank": apps.PageRank(), "bfs": apps.BFS(),
             "landmarks": apps.LandmarkDistances(landmarks=(0, 1))}
    pairs = [(be, br) for be in BLOCK_E for br in BLOCK_R]
    cases = []
    for name, q in TUNE_FUSED:
        args, _ = fused_inputs(torch, progs[name], dst, nr, r, q, gen)
        spec = args[0]
        cases.append(dict(
            kernel="gab_fused", spec=name, q=q, combine=spec.combine,
            run=lambda bl, a=args: gab_fused.gab_fused(*a, blocks=bl),
            plain=lambda a=args: ref.gab_fused_ref(*a),
            bound=fused_bound(args), library=None))
    for q in TUNE_SEGMENT_Q:
        c = torch.rand((e,) if q == 1 else (e, q), generator=gen, device=dev)
        idx = dst.long() if q == 1 else dst.long()[:, None].expand(
            e, q).contiguous()
        init = torch.zeros((r + 1,) + tuple(c.shape[1:]), device=dev)
        cases.append(dict(
            kernel="segment_reduce", spec="sum", q=q, combine="sum",
            run=lambda bl, c=c: (gab_gather.segment_reduce(
                c, dst, r + 1, "sum", blocks=bl),),
            plain=lambda c=c: ref.segment_reduce(c, dst, r + 1, "sum"),
            bound=bound(e * 4 + e * 4 * q + (r + 1) * 4 * q, e * q),
            library=lambda c=c, i=idx, z=init: torch.scatter_reduce(
                z, 0, i, c, "sum")))
    rows = []
    for case in cases:
        want = case["run"](None)
        pick = kernel_tune.pick_blocks(case["combine"], case["q"], e, r)
        cands = []
        for bl in pairs:
            got = case["run"](bl)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(
                    f"tune {case['kernel']} {case['spec']} Q={case['q']}: "
                    f"blocks {bl} differ from the default's")
            ms = time_ms(torch, lambda bl=bl: case["run"](bl), flush)
            pred = kernel_tune.tile_cost(case["combine"], case["q"], e, r,
                                         *bl).predicted_s * 1e3
            cands.append(dict(blocks=list(bl), ms=ms, predicted_ms=pred))
        best = min(cands, key=lambda c: c["ms"])
        by = {tuple(c["blocks"]): c for c in cands}
        pick_ms = by[pick.blocks]["ms"]
        plain = case["plain"]()
        plain = plain[0] if isinstance(plain, tuple) else plain
        row = dict(kernel=case["kernel"], spec=case["spec"], q=case["q"],
                   pick=list(pick.blocks), stack_size=pick.stack_size,
                   pick_ms=pick_ms, best=best["blocks"], best_ms=best["ms"],
                   default_ms=by[DEFAULT_BLOCKS]["ms"],
                   pick_over_best=pick_ms / best["ms"],
                   candidates=cands, bound_ms=case["bound"][0],
                   bound_by=case["bound"][1],
                   max_abs_err=max_abs_err(torch, want[0], plain),
                   kernel_ms=pick_ms,
                   plain_ms=time_ms(torch, case["plain"], flush),
                   library_ms=(None if case["library"] is None else
                               time_ms(torch, case["library"], flush)))
        rows.append(row)
        log(f"tune {case['kernel']} {case['spec']} Q={case['q']}: "
            f"{len(pairs)} pairs equal to the default bit for bit; pick "
            f"{pick.blocks} {pick_ms:.4f} ms (predicted "
            f"{by[pick.blocks]['predicted_ms']:.4f}), best "
            f"{tuple(best['blocks'])} {best['ms']:.4f} ms, default "
            f"{row['default_ms']:.4f} ms; pick / best "
            f"{row['pick_over_best']:.3f}; "
            + ", ".join(f"{tuple(c['blocks'])} {c['ms']:.4f}/"
                        f"{c['predicted_ms']:.4f}" for c in cands))
    return rows


def tune_engine_runs(torch, store, pr, msbfs, sources):
    """Phase 17c: the engine with kernel_autotune at the depth of a
    default-block run, each equal to it bit for bit and each launching
    the fused kernel at the tuner's blocks: tiled PageRank for
    PR_SUPERSTEPS (phase 5's run), MultiSourceBFS at Q = 8 tiled and
    pipelined (the tuner's stack size) to convergence (phase 8's run).
    The launch counters are read around the three runs ("tune")."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank

    reset_launches()
    eng = engine(store, tile_skipping=False, kernel_autotune=True)
    p = eng.run(PageRank(), max_supersteps=PR_SUPERSTEPS)
    picks = {"pagerank": eng.kernel_choice}
    if not same_bits(p.values, pr.values):
        raise AssertionError("tune: autotuned pagerank differs from the "
                             "default blocks' run")
    rows = [dict(app="pagerank", mode="tiled",
                 blocks=list(eng.kernel_choice.blocks),
                 stack_size=eng.kernel_choice.stack_size,
                 summary=app_summary("pagerank autotuned", p))]
    for pipeline in (False, True):
        eng = engine(store, tile_skipping=False, kernel_autotune=True,
                     pipeline=pipeline)
        m = eng.run(MultiSourceBFS(sources=sources),
                    max_supersteps=BFS_MAX_SUPERSTEPS)
        name = "pipelined" if pipeline else "tiled"
        if not (same_bits(m.values, msbfs.values)
                and np.array_equal(m.per_query_supersteps,
                                   msbfs.per_query_supersteps)):
            raise AssertionError(f"tune: autotuned msbfs ({name}) differs "
                                 "from the default blocks' run")
        c = eng.kernel_choice
        picks[f"msbfs {name}"] = c
        rows.append(dict(app=f"msbfs Q={len(sources)}", mode=name,
                         blocks=list(c.blocks), stack_size=c.stack_size,
                         summary=app_summary(f"msbfs {name} autotuned",
                                             m)))
        del eng
        torch.cuda.empty_cache()
    launches = read_launches()
    require_launches(launches, ("gab_fused",), "tune")
    log("tune: autotuned runs equal the default blocks' bit for bit: "
        + ", ".join(f"{k} {c.blocks} stack {c.stack_size}"
                    for k, c in picks.items()))
    return rows, launches


def baselines_phase(torch, store, src, dst, pr):
    """Phase 18: the paper's comparison engines (core/baselines.py) on the
    main store's graph with device="cuda", PageRank for
    BASELINE_SUPERSTEPS each, against a float64 power iteration at that
    depth (rtol PR_RTOL), each's ms a superstep beside the tiled GAB
    engine's (phase 5) — the paper's Fig. 10 comparison.  Their edge and
    message files go to build/ and are removed."""
    from repro_torch.core.apps import PageRank
    from repro_torch.core.baselines import ENGINES

    nv = store.load_plan().num_vertices
    out_degree = store.load_degrees()[1]
    want = ref_pagerank(torch, src, dst, out_degree, nv,
                        BASELINE_SUPERSTEPS)
    work = os.path.join(ROOT, "build", "chip_smoke_baselines")
    rows = []
    for name, cls in ENGINES.items():
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        kw = dict(workdir=work) if name in ("graphd", "chaos") else {}
        t0 = time.perf_counter()
        eng = cls(src, dst, None, nv, device=DEV, **kw)
        build_s = time.perf_counter() - t0
        res = eng.run(PageRank(), max_supersteps=BASELINE_SUPERSTEPS)
        del eng
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
        rel = float(np.max(np.abs(res.values - want) / want))
        if len(res.history) != BASELINE_SUPERSTEPS or rel > PR_RTOL:
            raise AssertionError(f"baseline {name}: {len(res.history)} "
                                 f"supersteps, max rel err {rel:.3g} against "
                                 "float64")
        h = res.history
        rows.append(dict(
            engine=name, build_s=build_s, max_rel_err=rel,
            ms_per_superstep=[x.seconds * 1e3 for x in h],
            network_bytes=[x.network_bytes for x in h],
            disk_read_bytes=[x.disk_read_bytes for x in h],
            disk_write_bytes=[x.disk_write_bytes for x in h]))
        ms = ", ".join(f"{x.seconds * 1e3:.1f}" for x in h)
        log(f"baseline {name}: {ms} ms a superstep (built in {build_s:.1f} "
            f"s), max rel err {rel:.3g} against float64; network "
            f"{h[-1].network_bytes}, disk read {h[-1].disk_read_bytes}, "
            f"written {h[-1].disk_write_bytes} bytes in its last superstep")
    log(f"baselines beside the tiled GAB engine's {steady_ms(pr):.1f} ms a "
        "superstep (phase 5)")
    return dict(engines=rows, gab_tiled_ms=steady_ms(pr))


def lm_last_logits(torch, model, tokens, n_last):
    """Full forward (train mode) over tokens [1, S]: logits of the last
    n_last positions, [n_last, V]."""
    with torch.inference_mode():
        h, _ = model.hidden(tokens, mode="train")
        return model.logits(h[:, -n_last:])[0]


def lm_memory(torch):
    free, total = torch.cuda.mem_get_info()
    return dict(card_used_bytes=int(total - free),
                torch_peak_bytes=int(torch.cuda.max_memory_allocated()))


def lm_serve_phase(torch):
    """Phase 19: the dense decoders served at full width (module
    docstring)."""
    import contextlib
    import io

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model_zoo import build_model, param_count
    from repro_torch.serve.engine import Request, ServeEngine

    torch.set_float32_matmul_precision("highest")
    out = {}
    dev = torch.device(DEV)

    # (a) qwen3-1.7b through the serve CLI at its defaults
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config(LM_SERVE_ARCH)
    args = serve_cli.parse_args(["--arch", LM_SERVE_ARCH])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        outs = serve_cli.main(["--arch", LM_SERVE_ARCH, "--device", DEV])
    wall = time.perf_counter() - t0
    printed = buf.getvalue().splitlines()
    for line in printed:
        log(f"  {line}")
    m = re.match(r"(\d+) completions, (\d+) tokens in [\d.]+s \(([\d.]+) "
                 r"tok/s, (\d+) decode steps", printed[0])
    n_done, n_tok, tok_s, steps = (int(m.group(1)), int(m.group(2)),
                                   float(m.group(3)), int(m.group(4)))
    by_rid = {o.rid: o for o in outs}
    if n_done != args.requests or sorted(by_rid) != list(range(args.requests)) \
            or any(len(o.tokens) != args.max_new for o in outs):
        raise AssertionError(f"lm serve {LM_SERVE_ARCH}: {n_done} completions, "
                             f"lengths {sorted(len(o.tokens) for o in outs)}")
    prefill_ms = 1e3 * float(np.mean([o.prefill_s for o in outs]))
    decode_ms = 1e3 * sum(o.decode_s for o in outs) / steps
    mem_a = lm_memory(torch)
    torch.cuda.empty_cache()
    # the same model again (LM.init is deterministic on the card): two
    # requests served alone in a 1-slot engine give the batched tokens
    run = RunConfig(remat="none", q_chunk=64, kv_chunk=64,
                    compute_dtype="float32")
    model = build_model(cfg, run, DEV).init(args.seed)
    n_params = param_count(model)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(
        np.int32) for _ in range(args.requests)]
    for rid in LM_SINGLE_RIDS:
        one = ServeEngine(cfg, run, model, slots=1, max_len=args.max_len,
                          device=DEV).run_requests([Request(
                              rid=rid, prompt=prompts[rid],
                              max_new_tokens=args.max_new)])
        if one[0].tokens != by_rid[rid].tokens:
            raise AssertionError(f"lm serve: request {rid} alone gave "
                                 f"{one[0].tokens}, batched "
                                 f"{by_rid[rid].tokens}")
    # decode_step's logits for a 24-token sequence against the full forward
    seq = torch.from_numpy(np.random.default_rng(SEED + 19).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        cache = model.init_cache(1, 24, torch.float32)
        cache, _ = model.prefill(seq[:, :23], cache)
        _, dec = model.decode_step(seq[:, 23:], cache, 23)
    full = lm_last_logits(torch, model, seq, 1)
    err_a = float((dec[0, 0] - full[0]).abs().max())
    if not err_a <= LM_LOGITS_ATOL:
        raise AssertionError(f"lm serve {LM_SERVE_ARCH}: decode vs full "
                             f"forward max |err| {err_a:.3g} > "
                             f"{LM_LOGITS_ATOL}")
    out["a"] = dict(arch=LM_SERVE_ARCH, params=n_params, completions=n_done,
                    tokens=n_tok, decode_steps=steps, wall_s=wall,
                    tokens_per_s=tok_s, prefill_ms=prefill_ms,
                    decode_step_ms=decode_ms, decode_vs_full_max_abs=err_a,
                    single_slot_rids=list(LM_SINGLE_RIDS), **mem_a)
    log(f"lm serve {LM_SERVE_ARCH}: {n_params} params, {n_done} completions "
        f"of {args.max_new} tokens, {steps} decode steps; prefill "
        f"{prefill_ms:.1f} ms a request, {decode_ms:.2f} ms a decode step "
        f"({args.slots} slots), {tok_s:.1f} tokens/s; requests "
        f"{list(LM_SINGLE_RIDS)} alone equal; decode vs full forward max "
        f"|err| {err_a:.3g}; card {mem_a['card_used_bytes']} bytes in use, "
        f"torch peak {mem_a['torch_peak_bytes']}")
    del model, cache, dec, full, outs
    torch.cuda.empty_cache()

    # (b) gemma2-2b: one prompt past the window, decode against the full
    # forward, so the rolling cache is checked at full width
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config(LM_WINDOW_ARCH)
    run = RunConfig(remat="none", q_chunk=LM_WINDOW_CHUNK,
                    kv_chunk=LM_WINDOW_CHUNK, compute_dtype="float32")
    model = build_model(cfg, run, DEV).init(SEED)
    n_params = param_count(model)
    n, k = LM_WINDOW_PROMPT, LM_WINDOW_DECODE
    if n <= cfg.sliding_window:
        raise AssertionError("the prompt must pass the window")
    prompt = torch.from_numpy(np.random.default_rng(SEED + 20).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        cache = model.init_cache(1, n + k, torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, lg = model.prefill(prompt, cache)
        torch.cuda.synchronize()
        prefill_ms_b = 1e3 * (time.perf_counter() - t0)
        toks = [int(torch.argmax(lg[0, -1]))]
        logits = [lg[0, -1]]
        step_ms = []
        for i in range(k):
            t0 = time.perf_counter()
            cache, lg = model.decode_step(
                torch.tensor([[toks[-1]]], device=dev), cache, n + i)
            nxt = int(torch.argmax(lg[0, -1]))
            step_ms.append(1e3 * (time.perf_counter() - t0))
            toks.append(nxt)
            logits.append(lg[0, -1])
    windows = {c["k"].shape[1] for c in cache}
    seq = torch.cat([prompt, torch.tensor([toks[:k]], device=dev,
                                          dtype=prompt.dtype)], dim=1)
    full = lm_last_logits(torch, model, seq, k + 1)
    got = torch.stack(logits[:k + 1])
    err_b = float((got - full).abs().max())
    if not err_b <= LM_LOGITS_ATOL:
        raise AssertionError(f"lm serve {LM_WINDOW_ARCH}: decode past the "
                             f"window vs full forward max |err| {err_b:.3g} "
                             f"> {LM_LOGITS_ATOL}")
    mem_b = lm_memory(torch)
    out["b"] = dict(arch=LM_WINDOW_ARCH, params=n_params, prompt=n,
                    decoded=k, chunk=LM_WINDOW_CHUNK,
                    cache_lengths=sorted(windows), prefill_ms=prefill_ms_b,
                    decode_step_ms=step_ms,
                    tokens_per_s=k / (sum(step_ms) / 1e3),
                    decode_vs_full_max_abs=err_b, **mem_b)
    log(f"lm serve {LM_WINDOW_ARCH}: {n_params} params; a {n}-token prompt "
        f"(cache lengths {sorted(windows)}) prefilled in {prefill_ms_b:.1f} "
        f"ms at chunks of {LM_WINDOW_CHUNK}, {k} decode steps "
        f"{np.mean(step_ms):.2f} ms each ({out['b']['tokens_per_s']:.1f} "
        f"tokens/s); prefill and decode vs full forward max |err| "
        f"{err_b:.3g}; card {mem_b['card_used_bytes']} bytes in use, torch "
        f"peak {mem_b['torch_peak_bytes']}")
    del model, cache, full, got, logits
    torch.cuda.empty_cache()
    out["logits_atol"] = LM_LOGITS_ATOL
    return out


def tune_case(r):
    what = (f"{r['spec']} spec" if r["kernel"] == "gab_fused"
            else r["spec"])
    return f"tile, {what}, Q={r['q']}, tuned blocks {tuple(r['pick'])}"


def kernel_entry(name, source, replaces, launches, by_path, err, row, case):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=row["kernel_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                case=case, launches_by_path=by_path,
                **{k: row[k] for k in ("library_full_ms", "composition_ms")
                   if k in row})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    phase_s = {}

    def mark(name, t0):
        phase_s[name] = time.perf_counter() - t0
        line = (f"[phase {name}: {phase_s[name]:.1f} s, "
                f"{time.perf_counter() - t_all:.1f} s in all]")
        log(line)
        print(line, file=sys.stderr, flush=True)

    # a run still going near the time limit prints every thread's stack
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_info(torch)

    t0 = time.perf_counter()
    builds = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(builds)} (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, b in builds.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", b["ptxas"])]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill",
                                                b["ptxas"]))
        log(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers a thread, {spills} bytes of spills")
    mark("build", t0)

    store_root = os.path.join(ROOT, "build", "chip_smoke_store")
    ckpt_root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(store_root, ignore_errors=True)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        store, plan, src, dst, store_info = build_store(store_root)
        nv = plan.num_vertices
        mark("store", t0)

        t0 = time.perf_counter()
        big = int(np.argmax(plan.edges_per_tile))
        tile = store.read_tile(big)
        log(f"kernel shapes from tile {big}: E {plan.edge_cap}, "
            f"R {plan.row_cap}, {tile.meta.num_edges} real edges, "
            f"{tile.meta.num_rows} rows")
        tile_lengths = row_lengths(tile.dst_local, plan.row_cap + 1,
                                   f"tile {big}")
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
        check_segment_order(torch, tile, plan)
        seg_rows, seg_err = check_segment_kernel(torch, tile, plan, flush)
        merged_row, merged_err = check_merged_segment(torch, dst, nv, flush)
        seg_rows.append(merged_row)
        skewed_rows = check_segment_skewed_int32(torch, flush)
        seg_rows.extend(skewed_rows)
        int32_launches = segment_int32_launches(torch, tile, plan)
        seg_err = max(seg_err, merged_err)
        fused_rows, fused_err = check_fused_kernel(torch, tile, plan, flush)
        pad_rows, pad_err = check_fused_padding_hub(torch, tile, plan, flush)
        fused_err = max(fused_err, pad_err)
        compact_rows, compact_err = check_compact_kernel(torch, nv, flush)
        del flush
        torch.cuda.empty_cache()
        mark("kernels", t0)

        t0 = time.perf_counter()
        eng, main_launches, summaries, pr_rel, pr, bfs, indeg = main_path(
            torch, store, src, dst)
        mark("main path", t0)
        t0 = time.perf_counter()
        compact_launches, compact_counts = compact_path(torch, bfs)
        mark("compact path", t0)
        t0 = time.perf_counter()
        prof = profile_superstep(torch, engine(store, tile_skipping=False),
                                 PageRank(), "pagerank")
        del eng
        mark("profile pagerank", t0)

        # phase 11 and the out-of-core parts of phases 12 and 15 run in
        # side processes beside phases 8-10 (host work; the card idles)
        out_degree = store.load_degrees()[1]
        sources = pick_sources(out_degree)
        s9, s10 = pick_admitted(src, dst, out_degree, sources)
        side_ooc = Side("ooc_phase", store_root, indeg)
        side_admission = Side("admission_ooc", store_root, sources, s9, s10)
        side_ckpt = Side("checkpoint_ooc", store_root, ckpt_root)

        t0 = time.perf_counter()
        (sources, batched_launches, batched, msbfs, levels,
         ppr_err) = batched_apps(torch, store, src, dst, bfs)
        mark("batched apps", t0)
        t0 = time.perf_counter()
        mode_rows, mode_launches = modes(torch, store, sources, pr, msbfs)
        mark("modes", t0)
        t0 = time.perf_counter()
        prof_q = profile_superstep(torch, engine(store, tile_skipping=False),
                                   MultiSourceBFS(sources=sources),
                                   f"msbfs Q={len(sources)}")
        mark("profile msbfs", t0)

        t0 = time.perf_counter()
        footprints = time_footprints(store, plan)
        ooc_rows, prof_ooc, ooc_launches = side_ooc.join()
        mark("ooc", t0)
        t0 = time.perf_counter()
        admission_ooc_part = side_admission.join()
        ckpt_ooc_part = side_ckpt.join()
        mark("side processes", t0)
        t0 = time.perf_counter()
        admission, admission_launches = admission_phase(
            torch, store, sources, s9, s10, msbfs, levels, admission_ooc_part)
        ooc_rows.append(admission["ooc"])
        mark("admission", t0)
        t0 = time.perf_counter()
        mesh, mesh_launches = mesh_phase(torch, store, pr, msbfs, sources)
        mark("mesh", t0)
        t0 = time.perf_counter()
        cluster, cluster_launches, single = cluster_phase(
            torch, store, pr, sources, admission["s9"])
        mark("cluster", t0)
        t0 = time.perf_counter()
        checkpoint, ckpt_launches = checkpoint_phase(
            torch, store, pr, single, sources, s9, ckpt_root, ckpt_ooc_part)
        mark("checkpoint", t0)
        t0 = time.perf_counter()
        serve, serve_launches = serve_phase(
            torch, store, src, dst, sources, msbfs, levels,
            admission["s9"], admission["s10"])
        mark("serve", t0)
        t0 = time.perf_counter()
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
        calibration = calibrate_tuner(torch, flush, tile, plan)
        tune_rows = tune_candidates(torch, tile, plan, flush)
        del flush
        torch.cuda.empty_cache()
        tune_runs, tune_launches = tune_engine_runs(torch, store, pr, msbfs,
                                                    sources)
        mark("tune", t0)
        t0 = time.perf_counter()
        baselines = baselines_phase(torch, store, src, dst, pr)
        mark("baselines", t0)
        t0 = time.perf_counter()
        reset_launches()
        lm_serve = lm_serve_phase(torch)
        lm_launches = read_launches()
        log(f"lm serve launches: {lm_launches} (the LM path runs no "
            "kernel of the graph engine)")
        mark("lm serve", t0)
    finally:
        shutil.rmtree(store_root, ignore_errors=True)
        shutil.rmtree(ckpt_root, ignore_errors=True)

    paths = {"main path": main_launches, "compact path": compact_launches,
             "batched apps": batched_launches, "modes": mode_launches,
             "ooc": ooc_launches, **admission_launches, **mesh_launches,
             **cluster_launches, **ckpt_launches, **serve_launches,
             "tune": tune_launches, "lm serve": lm_launches}
    total = {k: sum(p[k] for p in paths.values()) for k in main_launches}
    log(f"launches by path: {paths}; total {total}")

    def by_path(name):
        return {p: c[name] for p, c in paths.items()}

    serve_err = max(r["max_abs_err"] for r in serve["kernel_cases"])
    seg_src = ("segment_reduce",
               "src/repro_torch/kernels/csrc/segment_reduce.cu",
               "src/repro/kernels/gab_gather.py:127",
               total["segment_reduce"], by_path("segment_reduce"), seg_err)
    fused_src = ("gab_fused", "src/repro_torch/kernels/csrc/gab_fused.cu",
                 "src/repro/kernels/gab_fused.py:294", total["gab_fused"],
                 by_path("gab_fused"), max(fused_err, serve_err))
    compact_src = ("compact", "src/repro_torch/kernels/csrc/compact.cu",
                   "src/repro/kernels/compact.py:107", total["compact"],
                   by_path("compact"), compact_err)
    serve_case = max(serve["kernel_cases"], key=lambda r: r["launches"])

    def compact_case(n, density):
        return next(r for r in compact_rows
                    if r["n"] == n and r["density"] == density
                    and r["fill"] is None and r["offset"] == 0
                    and r["dtype"] == "torch.float32")

    kernels = [
        kernel_entry(*seg_src, next(r for r in seg_rows
                                    if r["combine"] == "sum" and r["q"] == 1
                                    and "shape" not in r),
                     "tile, sum, Q=1"),
        kernel_entry(*seg_src, next(r for r in seg_rows
                                    if r["combine"] == "sum"
                                    and r["q"] == NUM_QUERIES),
                     f"tile, sum, Q={NUM_QUERIES}"),
        kernel_entry(*seg_src, merged_row, "merged shape, sum, Q=1"),
        *(kernel_entry(*seg_src, r, f"C.1 skewed list, int32 {r['combine']}, "
                       f"Q=1, all {r['pairs']} block pairs equal")
          for r in skewed_rows),
        *(kernel_entry(*fused_src, next(r for r in fused_rows
                                        if r["spec"] == "pagerank"
                                        and r["q"] == q),
                       f"tile, PageRank spec, Q={q}")
          for q in (1, NUM_QUERIES)),
        kernel_entry(*fused_src, next(r for r in fused_rows
                                      if r["spec"] == "bfs"
                                      and r["q"] == NUM_QUERIES + 1),
                     f"tile, BFS spec, Q={NUM_QUERIES + 1}"),
        kernel_entry(*fused_src, serve_case,
                     f"tile, {serve_case['spec']} spec, Q={serve_case['q']} "
                     f"(the serve path's most launched shape)"),
        kernel_entry(*compact_src, compact_case(nv, 0.05),
                     f"V={nv}, density 0.05"),
        kernel_entry(*compact_src, compact_case(1 << 25, 0.01),
                     "V=2^25, density 0.01"),
        *({**kernel_entry(*(fused_src if r["kernel"] == "gab_fused"
                            else seg_src)[:5], r["max_abs_err"], r,
                          tune_case(r)), "blocks": r["pick"]}
          for r in tune_rows),
    ]
    seconds = time.perf_counter() - t_all
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, builds={
                           k: v["seconds"] for k, v in builds.items()},
                       store=store_info, tile_row_lengths=tile_lengths,
                       segment=seg_rows, fused=fused_rows,
                       segment_int32_launches=int32_launches,
                       fused_padding_hub=pad_rows,
                       compact=compact_rows, compact_path=compact_counts,
                       apps=summaries, pagerank_max_rel_err=pr_rel,
                       sources=list(sources), batched=batched,
                       batched_errors=ppr_err, modes=mode_rows,
                       profile=prof, profile_msbfs=prof_q,
                       footprints=footprints, ooc=ooc_rows,
                       profile_ooc=prof_ooc, admission=admission,
                       mesh=mesh, cluster=cluster, checkpoint=checkpoint,
                       serve=serve, tune_calibration=calibration,
                       tune=tune_rows, tune_runs=tune_runs,
                       baselines=baselines, lm_serve=lm_serve,
                       launches_by_path=paths, kernels=kernels,
                       phase_seconds=phase_s, seconds=seconds), f, indent=1)
    faulthandler.cancel_dump_traceback_later()
    log(f"total {seconds:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
