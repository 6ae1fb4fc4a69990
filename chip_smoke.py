#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the three CUDA kernels from src/repro_torch/kernels/csrc, one
   nvcc each, started together.
3. Main-path store: SPE of an R-MAT graph (Graph500 a, b, c = 0.57, 0.19,
   0.19) at SCALE 22, edge factor 16 — 4,194,304 vertices, 67,108,864
   edges — in tiles of 2^20 edges, unweighted, disk mode 1.
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
   3.35 TB/s, flops over 67 TFLOP/s; the fused kernel's counts the real
   edges and base over num_rows rows only, the work its function needs).
5. Main path: OutOfCoreEngine(store, device="cuda", seg_impl="fused") runs
   PageRank for 5 supersteps (against a float64 numpy power iteration,
   rtol=1e-4: float32 against float64), BFS from vertex 0 to convergence
   (equal to a numpy level-synchronous BFS) and InDegree for 1 superstep
   (equal to np.bincount).
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
   scipy's BFS from its source, column 0 equal to phase 5's BFS);
   LandmarkDistances on the unweighted store (edge weight 1.0, the b
   stream), equal to MultiSourceBFS with equal per-query supersteps;
   PersonalizedPageRank for 3 supersteps against a float64 scipy.sparse
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
    as it loads the tile (timed once over all tiles); PageRank for 5
    supersteps under an 8 MiB vertex budget (superstep 1 profiled: H2D
    bytes of the sharded step, copy and kernel device time, the host
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
    to scipy's BFS levels up to 3 with -1, the other originals to phase
    8's Q = 8 run; its first ADMIT_OOC_SUPERSTEPS supersteps (Q = 8, 8,
    9, 8: the ninth query's admission, its Q = 9 superstep, the drain,
    the ninth query's retirement and the tenth's admission into the
    freed slot) in memory and under a 32 MiB budget equal bit for bit,
    the latter with 64 fused calls a superstep and its budget binding.
    Device bytes outside torch's allocator (the hub scratch) are logged
    around each superstep and each phase 4 fused case.
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

Phases 5, 6, 8, 9, 11, 13 and 14, the in-memory session of 12 and its
out-of-core session ("admission ooc") each set every kernel's launch
counter to 0 just before and read it just after (phase 14's ranks and
phase 13's gloo ranks count in their processes and report); each must
have launched the kernels it runs.  The
``{"kernels": [...]}`` line gives, per kernel and case, the launches
summed over those phases and the case's times: segment sum at the largest
tile for Q = 1 and Q = 8 and at the merged shape, the fused PageRank spec
at Q = 1 and Q = 8 and BFS spec at Q = 9 (with "composition_ms"),
compact at V = 4,194,304,
density 0.05 and at V = 2^25 (the "case" key names it).  Then, as its last line,
``{"ok": true, "device": {...}}``.  Any failed check raises; without a CUDA
device, or without the repository beside it, it exits non-zero before
printing a result.  Details go to build/chip_smoke.json.
"""
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
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, float32 outside tensor cores
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
SPIN_CYCLES = 1_000_000      # ~0.5 ms of device clock before each timed call
PR_RTOL = 1e-4
PPR_MIN_ENTRY = 1e-6
PPR_L1 = 1e-5
PPR_MAX_FLIP_SHARE = 1e-4
PAD_HUB_EDGES = 20000        # real edges turned into padding (phase 4)
OOC_INTERVALS = 16           # interval plan of the out-of-core runs
OOC_PR_BUDGET = 8 << 20      # PageRank / InDegree vertex budget, bytes
OOC_MSBFS_BUDGET = 32 << 20  # MultiSourceBFS (Q = 8 and 9) vertex budget
DRAIN_AT = 2                 # admission: drain query DRAIN_QID after this
DRAIN_QID = 1                # superstep
ADMIT_OOC_SUPERSTEPS = 4     # admission session compared out of core
DEV = "cuda"


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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
    chunks = list(synth.rmat_edges(nv, ne, seed=SEED))
    src = np.concatenate([c[0] for c in chunks])
    dst = np.concatenate([c[1] for c in chunks])
    t_gen = time.perf_counter() - t0
    store = TileStore(root, disk_mode=1)
    t0 = time.perf_counter()
    plan = spe.preprocess_arrays(src, dst, None, nv, store,
                                 tile_size=TILE_SIZE)
    t_spe = time.perf_counter() - t0
    log(f"store: SCALE {SCALE}, {nv} vertices, {ne} edges, "
        f"{plan.num_tiles} tiles, edge_cap {plan.edge_cap}, row_cap "
        f"{plan.row_cap}; R-MAT {t_gen:.1f} s, SPE {t_spe:.1f} s")
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
            # the hub launch's scratch grows by cudaMalloc beside torch's
            # allocator when a call needs more (ROADMAP B.4)
            row["non_torch_growth"] = non_torch_device_bytes(torch) - m0
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


def numpy_pagerank(src, dst, out_degree, nv, steps):
    inv = np.zeros(nv, dtype=np.float32)
    nz = out_degree > 0
    inv[nz] = 1.0 / out_degree[nz]
    w = inv.astype(np.float64)[src]
    pr = np.ones(nv, dtype=np.float64)
    for _ in range(steps):
        pr = 0.15 + 0.85 * np.bincount(dst, weights=pr[src] * w, minlength=nv)
    return pr


def numpy_bfs(src, dst, nv, source):
    level = np.full(nv, np.inf, dtype=np.float32)
    level[source] = 0.0
    frontier = np.zeros(nv, dtype=bool)
    frontier[source] = True
    d = 0
    while frontier.any():
        cand = dst[frontier[src]]
        cand = np.unique(cand[np.isinf(level[cand])])
        d += 1
        level[cand] = d
        frontier[:] = False
        frontier[cand] = True
    return level


def scipy_bfs(src, dst, nv, sources):
    """BFS levels [V, Q] float32 from each source (inf where unreached),
    by scipy's breadth-first shortest paths over the edge list."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    g = sp.csr_matrix((np.ones(len(src), np.float32), (src, dst)),
                      shape=(nv, nv))
    return shortest_path(g, unweighted=True,
                         indices=list(sources)).T.astype(np.float32)


def scipy_ppr(src, dst, out_degree, nv, seeds, steps, tol):
    """float64 personalized PageRank with the engine's update gate: a cell
    takes its new value only where it moved by more than ``tol``."""
    import scipy.sparse as sp

    inv = np.zeros(nv, dtype=np.float32)
    nz = out_degree > 0
    inv[nz] = 1.0 / out_degree[nz]
    a = sp.csr_matrix((inv.astype(np.float64)[src], (dst, src)),
                      shape=(nv, nv))
    seed_mass = np.zeros((nv, len(seeds)))
    seed_mass[np.asarray(seeds), np.arange(len(seeds))] = 1.0
    x = seed_mass.copy()
    for _ in range(steps):
        new = 0.15 * seed_mass + 0.85 * (a @ x)
        x = np.where(np.abs(new - x) > tol, new, x)
    return x


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
    want = numpy_pagerank(src, dst, eng.out_degree, nv, PR_SUPERSTEPS)
    if not np.isfinite(pr.values).all():
        raise AssertionError("pagerank: non-finite values")
    rel = float(np.max(np.abs(pr.values - want) / want))
    log(f"pagerank vs float64 numpy: max rel err {rel:.3g} "
        f"(limit {PR_RTOL})")
    if rel > PR_RTOL:
        raise AssertionError("pagerank disagrees with numpy")
    if not bfs.converged:
        raise AssertionError("bfs did not converge")
    level = numpy_bfs(src, dst, nv, 0)
    if not np.array_equal(bfs.values, level):
        raise AssertionError("bfs differs from numpy BFS")
    log(f"bfs equals numpy BFS: {int(np.isfinite(level).sum())} reached, "
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
    levels = scipy_bfs(src, dst, nv, sources)
    for q, s in enumerate(sources):
        if not np.array_equal(msbfs.values[:, q], levels[:, q]):
            raise AssertionError(f"msbfs column {q} (source {s}) differs "
                                 "from scipy's BFS")
    if not np.array_equal(msbfs.values[:, 0], bfs.values):
        raise AssertionError("msbfs column 0 differs from the Q = 1 BFS")
    log(f"msbfs equals scipy's BFS in all {len(sources)} columns; column 0 "
        f"equals the single-query BFS; per-query supersteps "
        f"{list(msbfs.per_query_supersteps)}")
    if not (np.array_equal(lm.values, msbfs.values)
            and np.array_equal(lm.per_query_supersteps,
                               msbfs.per_query_supersteps)):
        raise AssertionError("landmarks differ from msbfs")
    log("landmarks (edge weight 1.0) equal msbfs, per-query supersteps too")

    tol = PersonalizedPageRank().update_tol
    want = scipy_ppr(src, dst, eng.out_degree, nv, sources, PPR_SUPERSTEPS,
                     tol)
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
    log(f"ppr vs float64 scipy: max rel err {rel:.3g} on {rel_all.size - n_over}"
        f" entries >= {PPR_MIN_ENTRY} (limit {PR_RTOL}); {n_over} gate flips "
        f"(max rel {float(rel_all.max()):.3g}, max abs err {flip_err:.3g}, "
        f"limit {PPR_SUPERSTEPS * tol:.3g}); max L1 per column {l1:.3g} "
        f"(limit {PPR_L1})")
    if (l1 > PPR_L1 or flip_err > PPR_SUPERSTEPS * tol
            or n_over > PPR_MAX_FLIP_SHARE * rel_all.size):
        raise AssertionError("ppr disagrees with scipy")
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
    context and the hub launch's scratch, which grows by cudaMalloc)."""
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


def ooc_phase(torch, store, pr, indeg):
    """Out-of-core vertex state on the main store with OOC_INTERVALS
    intervals: PageRank (budget OOC_PR_BUDGET, PR_SUPERSTEPS supersteps,
    superstep 1 profiled) and InDegree (OOC_PR_BUDGET, 1 superstep, the
    segment kernel), each bit for bit equal to the in-memory tiled run of
    as many supersteps; the budget must bind.  MultiSourceBFS under
    OOC_MSBFS_BUDGET runs in phase 12's out-of-core session."""
    from repro_torch.core.apps import InDegree, PageRank

    num_tiles = store.load_plan().num_tiles
    out, launches = [], {}
    reset_launches()
    eng = engine(store, tile_skipping=False, num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_PR_BUDGET)
    sess = eng.open_session(PageRank(), max_supersteps=PR_SUPERSTEPS)
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
    if not same_bits(res.values, pr.values):
        raise AssertionError("pagerank ooc differs from the tiled run")
    out.append(vstate_summary("pagerank ooc", res, steady_ms(pr),
                              eng.vstate.stats.as_dict(),
                              eng.vstate.num_intervals))
    if launches["pagerank"]["gab_fused"] != num_tiles * PR_SUPERSTEPS:
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


def admission_phase(torch, store, src, dst, sources, msbfs, levels):
    """Mid-run admission at SCALE 22: the session of admission_script in
    memory to convergence (tile skipping on, as users run it), each
    admitted column against a fresh single-query run, the drained one
    against scipy's BFS levels up to DRAIN_AT + 1; then its first
    ADMIT_OOC_SUPERSTEPS supersteps in memory and under OOC_MSBFS_BUDGET,
    equal bit for bit — the latter is also the out-of-core MultiSourceBFS
    run at Q = 8 (supersteps 0 and 1), Q = 9 (superstep 2) and, after
    the drain, Q = 8 (superstep 3, at whose barrier the ninth column
    retires and the tenth is admitted).  The launch counters are read
    around the two sessions alone: "admission" (in memory) and
    "admission ooc"."""
    from repro_torch.core.apps import MultiSourceBFS

    s9, s10 = pick_admitted(src, dst, store.load_degrees()[1], sources)
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

    cut = ADMIT_OOC_SUPERSTEPS
    mem, mem_steps, _, _ = admission_script(
        torch, engine(store, tile_skipping=False, admit_plan=plan), sources,
        s10, cut)
    eng = engine(store, tile_skipping=False, admit_plan=plan,
                 num_intervals=OOC_INTERVALS,
                 vertex_memory_budget=OOC_MSBFS_BUDGET)
    reset_launches()
    ooc, ooc_steps, _, _ = admission_script(torch, eng, sources, s10, cut)
    launches["admission ooc"] = read_launches()
    require_launches(launches["admission ooc"], ("gab_fused",),
                     "admission ooc")

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
    # the window holds the scheduled admission, Q = 9, the drain, a
    # natural retirement and admit() into a freed slot
    if not (any(r["active_queries"] == q + 1 for r in ooc_steps)
            and [q] in [r["admitted"] for r in ooc_steps]
            and [DRAIN_QID] in [r["drained"] for r in ooc_steps]
            and any(q in r["retired"] for r in ooc_steps)
            and [g10] in [r["admitted"] for r in ooc_steps]):
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
    return dict(s9=s9, s10=s10, q10=g10, supersteps=res.supersteps,
                per_query_supersteps=[int(x) for x in pq], steps=steps,
                mem_steps=mem_steps, ooc_steps=ooc_steps, ooc=ooc_summary,
                fused_launches_at_q9=[r["fused_launches"] for r in nine],
                non_torch_growth_at_q9=[r["non_torch_growth"]
                                        for r in nine]), launches


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
                runs=out), launches


def kernel_entry(name, source, replaces, launches, err, row, case):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=row["kernel_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                case=case, **{k: row[k] for k in ("library_full_ms",
                                                  "composition_ms")
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
        log(f"[phase {name}: {phase_s[name]:.1f} s]")

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
    shutil.rmtree(store_root, ignore_errors=True)
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
        ooc_rows, prof_ooc, ooc_launches = ooc_phase(torch, store, pr, indeg)
        mark("ooc", t0)
        t0 = time.perf_counter()
        admission, admission_launches = admission_phase(
            torch, store, src, dst, sources, msbfs, levels)
        ooc_rows.append(admission["ooc"])
        mark("admission", t0)
        t0 = time.perf_counter()
        mesh, mesh_launches = mesh_phase(torch, store, pr, msbfs, sources)
        mark("mesh", t0)
        t0 = time.perf_counter()
        cluster, cluster_launches = cluster_phase(torch, store, pr, sources,
                                                  admission["s9"])
        mark("cluster", t0)
    finally:
        shutil.rmtree(store_root, ignore_errors=True)

    paths = {"main path": main_launches, "compact path": compact_launches,
             "batched apps": batched_launches, "modes": mode_launches,
             "ooc": ooc_launches, **admission_launches, **mesh_launches,
             **cluster_launches}
    total = {k: sum(p[k] for p in paths.values()) for k in main_launches}
    log(f"launches by path: {paths}; total {total}")
    seg_src = ("segment_reduce",
               "src/repro_torch/kernels/csrc/segment_reduce.cu",
               "src/repro/kernels/gab_gather.py:127",
               total["segment_reduce"], seg_err)
    fused_src = ("gab_fused", "src/repro_torch/kernels/csrc/gab_fused.cu",
                 "src/repro/kernels/gab_fused.py:294", total["gab_fused"],
                 fused_err)
    compact_src = ("compact", "src/repro_torch/kernels/csrc/compact.cu",
                   "src/repro/kernels/compact.py:107", total["compact"],
                   compact_err)

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
        *(kernel_entry(*fused_src, next(r for r in fused_rows
                                        if r["spec"] == "pagerank"
                                        and r["q"] == q),
                       f"tile, PageRank spec, Q={q}")
          for q in (1, NUM_QUERIES)),
        kernel_entry(*fused_src, next(r for r in fused_rows
                                      if r["spec"] == "bfs"
                                      and r["q"] == NUM_QUERIES + 1),
                     f"tile, BFS spec, Q={NUM_QUERIES + 1}"),
        kernel_entry(*compact_src, compact_case(nv, 0.05),
                     f"V={nv}, density 0.05"),
        kernel_entry(*compact_src, compact_case(1 << 25, 0.01),
                     "V=2^25, density 0.01"),
    ]
    seconds = time.perf_counter() - t_all
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, builds={
                           k: v["seconds"] for k, v in builds.items()},
                       store=store_info, tile_row_lengths=tile_lengths,
                       segment=seg_rows, fused=fused_rows,
                       fused_padding_hub=pad_rows,
                       compact=compact_rows, compact_path=compact_counts,
                       apps=summaries, pagerank_max_rel_err=pr_rel,
                       sources=list(sources), batched=batched,
                       batched_errors=ppr_err, modes=mode_rows,
                       profile=prof, profile_msbfs=prof_q,
                       footprints=footprints, ooc=ooc_rows,
                       profile_ooc=prof_ooc, admission=admission,
                       mesh=mesh, cluster=cluster,
                       launches_by_path=paths, kernels=kernels,
                       phase_seconds=phase_s, seconds=seconds), f, indent=1)
    log(f"total {seconds:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
