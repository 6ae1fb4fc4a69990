#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the CUDA kernels from src/repro_torch/kernels/csrc with nvcc.
3. Main-path store: SPE of an R-MAT graph (Graph500 a, b, c = 0.57, 0.19,
   0.19) at SCALE 22, edge factor 16 — 4,194,304 vertices, 67,108,864
   edges — in tiles of 2^20 edges, unweighted, disk mode 1.
4. Kernels against their plain PyTorch versions on the card, at the shapes
   of the store's largest tile: the segment kernel (sum/min/max, Q in
   {1, 4}, sorted and unsorted dst, int32), the fused kernel (the four
   fused apps' specs and a weighted spec with both edge streams, Q in
   {1, 4}).  Min, max and integers must be equal, sums within
   rtol=1e-5, atol=1e-6 (another order of summation); the fused kernel's
   updated mask must equal the plain version's (for sums, on every row
   whose change is farther than that tolerance from update_tol) and leave
   rows past num_rows untouched.  Each is timed with
   CUDA events (L2 flushed between launches) beside the plain version, one
   scatter_reduce call where that computes the same function, and its
   bound (bytes over 3.35 TB/s, flops over 67 TFLOP/s).
5. Main path: OutOfCoreEngine(store, device="cuda", seg_impl="fused") runs
   PageRank for 5 supersteps (against a float64 numpy power iteration,
   rtol=1e-4: float32 against float64), BFS from vertex 0 to convergence
   (equal to a numpy level-synchronous BFS) and InDegree for 1 superstep
   (equal to np.bincount), with both kernels' launch counters set to 0
   before and read after.
6. One PageRank superstep under torch.profiler: device busy share and the
   kernels' device time.

Prints a ``{"kernels": [...]}`` line, then as its last line
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
BFS_MAX_SUPERSTEPS = 40
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, float32 outside tensor cores
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
PR_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


def card_info(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def time_ms(torch, fn, flush, reps=10):
    """Median device time of one call, CUDA events around each call, the L2
    cache flushed before each (the main path finds a tile cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def check_segment_kernel(torch, tile, plan, flush):
    """Segment kernel against ref.segment_reduce at the main path's shapes
    (InDegree: contrib [edge_cap], num_segments row_cap + 1)."""
    from repro_torch.kernels import gab_gather, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, r = plan.edge_cap, plan.row_cap + 1
    dst_sorted = torch.from_numpy(tile.dst_local).to(dev)
    perm = torch.randperm(e, generator=gen, device=dev)
    rows = []
    err = 0.0
    for combine in ("sum", "min", "max"):
        for q in (1, 4):
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
            idx = dst_sorted.long()
            if q > 1:
                idx = idx[:, None].expand(e, q).contiguous()
            init = torch.full((r,) + shape[1:], ref.identity(combine, c.dtype),
                              dtype=c.dtype, device=dev)
            lib_reduce = {"sum": "sum", "min": "amin", "max": "amax"}[combine]
            nbytes = e * 4 + e * 4 * q + r * 4 * q
            b_ms, b_by = bound(nbytes, e * q)
            row = dict(
                combine=combine, q=q,
                kernel_ms=time_ms(torch, lambda: gab_gather.segment_reduce(
                    c, dst_sorted, r, combine), flush),
                plain_ms=time_ms(torch, lambda: ref.segment_reduce(
                    c, dst_sorted, r, combine), flush),
                library_ms=time_ms(torch, lambda: torch.scatter_reduce(
                    init, 0, idx, c, lib_reduce), flush),
                bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(f"segment {combine} Q={q}: kernel {row['kernel_ms']:.4f} ms,"
                f" plain {row['plain_ms']:.4f} ms, scatter_reduce "
                f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    ci = torch.randint(-(1 << 30), 1 << 30, (e,), generator=gen, device=dev,
                       dtype=torch.int32)
    for combine in ("sum", "min", "max"):
        got = gab_gather.segment_reduce(ci, dst_sorted, r, combine)
        want = ref.segment_reduce(ci, dst_sorted, r, combine)
        check_equal_or_close(torch, got, want, True, f"segment int32 {combine}")
    log(f"segment kernel: all cases agree, max |err| {err:.3g}")
    return rows, err


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
    from repro_torch.core import apps
    from repro_torch.kernels.gab_fused import FusedSpec

    return {
        "pagerank": apps.PageRank().fused_spec(),
        "sssp": apps.SSSP().fused_spec(),
        "wcc": apps.WCC().fused_spec(),
        "bfs": apps.BFS().fused_spec(),
        "weighted": FusedSpec(combine="sum", scale_aux="w", add_edge=True,
                              apply="affine", alpha=0.15, beta=0.85,
                              update_tol=1e-9),
    }


def check_fused_kernel(torch, tile, plan, flush):
    """Fused kernel against ref.gab_fused_ref at the main path's shapes
    (PageRank, BFS: src_vals [edge_cap], old [row_cap])."""
    from repro_torch.kernels import gab_fused, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    e, r, nr = plan.edge_cap, plan.row_cap, tile.meta.num_rows
    dst = torch.from_numpy(tile.dst_local).to(dev)
    real = dst < nr
    ev = torch.where(real, torch.rand(e, generator=gen, device=dev) + 0.5,
                     torch.zeros((), device=dev))
    inv = torch.rand(e, generator=gen, device=dev)
    rows = []
    err = 0.0
    for name, spec in fused_cases().items():
        for q in (1, 4):
            tail = () if q == 1 else (q,)
            src = torch.rand((e,) + tail, generator=gen, device=dev) * 5
            if spec.combine == "min":
                src = torch.where(torch.rand(src.shape, generator=gen,
                                             device=dev) < 0.3,
                                  torch.full_like(src, float("inf")), src)
            old = torch.rand((r,) + tail, generator=gen, device=dev) * 5
            a = (inv * ev) if spec.scale_aux else None
            b = ev if spec.add_edge else None
            args = (spec, src, a, b, dst, old, None, nr, r)
            new, upd = gab_fused.gab_fused(*args)
            pnew, pupd = ref.gab_fused_ref(*args)
            what = f"fused {name} Q={q}"
            check_equal_or_close(torch, new, pnew, spec.combine != "sum", what)
            n_clear, n_rows = check_fused_mask(torch, spec, new, upd, pnew,
                                               pupd, old, nr, what)
            err = max(err, max_abs_err(torch, new, pnew))
            streams = int(a is not None) + int(b is not None)
            nbytes = e * (4 + 4 * q + 4 * streams) + r * q * (4 + 4 + 1)
            flops = e * q * (1 + streams + int(spec.add_const is not None))
            b_ms, b_by = bound(nbytes, flops + 3 * r * q)
            row = dict(
                spec=name, q=q,
                kernel_ms=time_ms(torch, lambda: gab_fused.gab_fused(*args),
                                  flush),
                plain_ms=time_ms(torch, lambda: ref.gab_fused_ref(*args),
                                 flush),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(f"{what}: kernel {row['kernel_ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                f"mask equal on {n_clear} of {n_rows} entries")
    log(f"fused kernel: all cases agree, max |err| {err:.3g}")
    return rows, err


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


def app_summary(name, res):
    h = res.history
    s = dict(
        app=name, supersteps=res.supersteps, converged=res.converged,
        ms_per_superstep=1e3 * res.total_seconds() / max(len(h), 1),
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
        updated=[x.updated_vertices for x in h])
    log(f"{name}: {s['supersteps']} supersteps, {s['ms_per_superstep']:.1f} "
        f"ms/superstep, load {s['load_seconds']:.2f} s, compute "
        f"{s['compute_seconds']:.2f} s, tiles {s['tiles_processed']} run / "
        f"{s['tiles_skipped']} skipped, broadcast {s['raw_bytes']} raw / "
        f"{s['wire_bytes']} wire bytes")
    return s


def main_path(torch, store, src, dst):
    from repro_torch.core.apps import BFS, InDegree, PageRank
    from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
    from repro_torch.kernels import gab_fused, gab_gather

    eng = OutOfCoreEngine(store, EngineConfig(num_servers=1, device="cuda",
                                              seg_impl="fused"))
    nv = eng.plan.num_vertices
    gab_gather.LAUNCHES = 0
    gab_fused.LAUNCHES = 0
    pr = eng.run(PageRank(), max_supersteps=PR_SUPERSTEPS)
    bfs = eng.run(BFS(source=0), max_supersteps=BFS_MAX_SUPERSTEPS)
    indeg = eng.run(InDegree(), max_supersteps=1)
    launches = {"segment_reduce": gab_gather.LAUNCHES,
                "gab_fused": gab_fused.LAUNCHES}
    log(f"main path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

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
    return eng, launches, summaries, rel


def profile_superstep(torch, eng):
    """One PageRank superstep under torch.profiler: device busy share and
    device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.apps import PageRank

    session = eng.open_session(PageRank(), max_supersteps=2)
    session.step()          # warm: the first superstep
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels and copies): a CPU op's device time
    # repeats its kernels'; "Activity Buffer Request" is the profiler's own
    cuda = torch.autograd.DeviceType.CUDA
    by_name = sorted(((e.device_time_total, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == cuda
                      and not e.key.startswith("Activity Buffer")),
                     reverse=True)
    busy = sum(t for t, _, _ in by_name) / 1e6
    out = dict(wall_s=wall, device_busy_s=busy,
               device_busy_share=busy / wall if wall else 0.0,
               top=[dict(name=k[:80], device_ms=t / 1e3, count=c)
                    for t, k, c in by_name[:12]])
    log(f"profiled pagerank superstep: wall {wall:.3f} s, device busy "
        f"{busy:.4f} s ({100 * out['device_busy_share']:.1f}%)")
    for row in out["top"]:
        log(f"  {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    return out


def kernel_entry(name, source, replaces, launches, err, row):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=row["kernel_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
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

    store_root = os.path.join(ROOT, "build", "chip_smoke_store")
    shutil.rmtree(store_root, ignore_errors=True)
    try:
        store, plan, src, dst, store_info = build_store(store_root)
        big = int(np.argmax(plan.edges_per_tile))
        tile = store.read_tile(big)
        log(f"kernel shapes from tile {big}: E {plan.edge_cap}, "
            f"R {plan.row_cap}, {tile.meta.num_edges} real edges, "
            f"{tile.meta.num_rows} rows")
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        seg_rows, seg_err = check_segment_kernel(torch, tile, plan, flush)
        fused_rows, fused_err = check_fused_kernel(torch, tile, plan, flush)
        del flush

        eng, launches, summaries, pr_rel = main_path(torch, store, src, dst)
        prof = profile_superstep(torch, eng)
    finally:
        shutil.rmtree(store_root, ignore_errors=True)

    kernels = [
        kernel_entry("segment_reduce",
                     "src/repro_torch/kernels/csrc/segment_reduce.cu",
                     "src/repro/kernels/gab_gather.py:127",
                     launches["segment_reduce"], seg_err,
                     next(r for r in seg_rows
                          if r["combine"] == "sum" and r["q"] == 1)),
        kernel_entry("gab_fused", "src/repro_torch/kernels/csrc/gab_fused.cu",
                     "src/repro/kernels/gab_fused.py:294",
                     launches["gab_fused"], fused_err,
                     next(r for r in fused_rows
                          if r["spec"] == "pagerank" and r["q"] == 1)),
    ]
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, builds={
                           k: v["seconds"] for k, v in builds.items()},
                       store=store_info, segment=seg_rows, fused=fused_rows,
                       apps=summaries, pagerank_max_rel_err=pr_rel,
                       profile=prof, kernels=kernels,
                       seconds=time.perf_counter() - t_all), f, indent=1)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
