"""Out-of-core graph analytics under memory pressure on the PyTorch port
— the paper's core scenario: edges >> cache, compressed edge cache,
bloom-filter tile skipping, and a comparison against the four baseline
engine mechanisms, on an H100 (or the CPU).

    PYTHONPATH=src python examples/graph_analytics_torch.py [--device cpu]

The same story as ``examples/graph_analytics.py``, through
``repro_torch``.  Where the ``zstandard`` package is missing the
compressed cache modes run on stdlib zlib at the same level
(``repro_torch.compat``), and the output says so.  ``--vertices``,
``--edges`` and ``--baseline-supersteps`` shrink the run (the defaults
are the reference's).
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.apps import SSSP, WCC
from repro_torch.core.baselines import ENGINES
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio import spe, synth
from repro_torch.graphio.formats import TileStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vertices", type=int, default=80_000)
    ap.add_argument("--edges", type=int, default=800_000)
    ap.add_argument("--baseline-supersteps", type=int, default=40)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    nv, ne, dev = args.vertices, args.edges, args.device
    print(f"R-MAT |V|={nv:,} |E|={ne:,} (weighted) on {dev}")
    store = TileStore(tempfile.mkdtemp(prefix="analytics_torch_"))
    spe.preprocess(lambda: synth.rmat_edges(nv, ne, seed=2, weighted=True),
                   nv, store, tile_size=32768, weighted=True)
    plan = store.load_plan()
    tile_bytes = sum(store.tile_disk_bytes(t) for t in range(plan.num_tiles))
    print(f"{plan.num_tiles} tiles, {tile_bytes/1e6:.0f} MB on disk")

    # constrained cache: only ~30% of tiles fit raw -> auto mode compresses
    cap = int(tile_bytes * 0.3)
    print(f"\n--- SSSP with {cap/1e6:.0f} MB cache/server "
          f"(auto-selected compression mode) ---")
    eng = OutOfCoreEngine(store, EngineConfig(
        num_servers=2, cache_capacity_bytes=cap // 2, cache_mode="auto",
        comm_mode="hybrid", tile_skipping=True, max_supersteps=100,
        device=dev))
    print(f"cache mode selected: {eng.cache_mode} "
          f"(1=raw 2=zstd-1 3=zstd-3 4=zstd-9)")
    if not compat.HAVE_ZSTD:
        print("zstandard is not installed: modes 2-4 run on stdlib zlib at "
              "the same level")
    t0 = time.time()
    res = eng.run(SSSP(source=0))
    reached = int(np.isfinite(res.values).sum())
    skipped = sum(h.tiles_skipped for h in res.history)
    print(f"SSSP: {res.supersteps} supersteps {time.time()-t0:.1f}s, "
          f"{reached:,} reachable, {skipped} tile loads skipped, "
          f"hit ratio {res.history[-1].cache_hit_ratio:.2f}")

    print("\n--- WCC on the symmetrized graph ---")
    store2 = TileStore(tempfile.mkdtemp(prefix="analytics_torch_sym_"))
    spe.preprocess(
        lambda: synth.symmetrized(synth.rmat_edges(nv, ne, seed=2)),
        nv, store2, tile_size=65536)
    eng2 = OutOfCoreEngine(store2, EngineConfig(num_servers=2,
                                                max_supersteps=100,
                                                device=dev))
    res2 = eng2.run(WCC())
    n_comp = len(np.unique(res2.values))
    print(f"WCC: {res2.supersteps} supersteps, {n_comp:,} components")

    print("\n--- baseline engine comparison (SSSP, same graph) ---")
    srcs, dsts, vals = [], [], []
    for s, d, v in synth.rmat_edges(nv, ne, seed=2, weighted=True):
        srcs.append(s), dsts.append(d), vals.append(v)
    src, dst, val = (np.concatenate(x) for x in (srcs, dsts, vals))
    rows = [("graphh", res.mean_superstep_seconds(),
             sum(h.network_bytes for h in res.history),
             sum(h.disk_bytes_read for h in res.history), res.values)]
    for name, cls in ENGINES.items():
        e = cls(src, dst, val, nv, num_servers=2, device=dev)
        r = e.run(SSSP(source=0), max_supersteps=args.baseline_supersteps)
        rows.append((name, r.mean_superstep_seconds(),
                     sum(h.network_bytes for h in r.history),
                     sum(h.disk_read_bytes + h.disk_write_bytes
                         for h in r.history), r.values))
    print(f"{'engine':12s} {'ms/superstep':>14s} {'net MB':>8s} "
          f"{'disk MB':>8s} {'reached':>9s}")
    for name, sec, net, disk, values in rows:
        print(f"{name:12s} {sec*1000:14.1f} {net/1e6:8.1f} {disk/1e6:8.1f} "
              f"{int(np.isfinite(values).sum()):9,d}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
