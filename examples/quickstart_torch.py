"""Quickstart on the PyTorch port: GraphH PageRank on a synthetic
power-law graph, end to end, on an H100 (or the CPU).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The same story as ``examples/quickstart.py``, through ``repro_torch``:
R-MAT generator -> SPE two-stage partitioning -> tile store ("DFS") ->
out-of-core GAB engine with edge cache + hybrid communication, its tile
steps on the card's hand-written kernels.  ``--vertices``, ``--edges``,
``--tile-size`` and ``--supersteps`` shrink the run (the defaults are the
reference's).
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.apps import PageRank
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio import spe, synth
from repro_torch.graphio.formats import TileStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vertices", type=int, default=50_000)
    ap.add_argument("--edges", type=int, default=500_000)
    ap.add_argument("--tile-size", type=int, default=32768)
    ap.add_argument("--supersteps", type=int, default=100,
                    help="step 3's cap (step 5 runs 10)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    nv, ne, dev = args.vertices, args.edges, args.device
    print(f"1. generating R-MAT graph: |V|={nv:,} |E|={ne:,} on {dev}")
    store = TileStore(tempfile.mkdtemp(prefix="quickstart_torch_"))

    print("2. SPE two-stage partitioning (degree pass -> splitter -> CSR tiles)")
    t0 = time.time()
    plan = spe.preprocess(lambda: synth.rmat_edges(nv, ne, seed=1),
                          nv, store, tile_size=args.tile_size)
    print(f"   {plan.num_tiles} tiles of <= {plan.edge_cap} edges "
          f"in {time.time()-t0:.1f}s")

    print("3. GAB supersteps on 4 emulated servers (AA replication, "
          "edge cache, hybrid broadcast)")
    eng = OutOfCoreEngine(store, EngineConfig(
        num_servers=4, cache_capacity_bytes=1 << 28, cache_mode="auto",
        comm_mode="hybrid", max_supersteps=args.supersteps, device=dev))
    t0 = time.time()
    res = eng.run(PageRank(update_tol=1e-9))
    print(f"   converged={res.converged} in {res.supersteps} supersteps, "
          f"{time.time()-t0:.1f}s "
          f"({res.mean_superstep_seconds()*1000:.0f} ms/superstep)")

    top = np.argsort(-res.values)[:5]
    print("4. top-5 vertices by rank:", [(int(v), round(float(res.values[v]), 2))
                                         for v in top])
    h = res.history[min(2, len(res.history) - 1)]
    print(f"   cache hit ratio {h.cache_hit_ratio:.2f} | broadcast mode "
          f"density {h.density:.2f} | wire {h.wire_bytes/1e6:.2f} MB/superstep")

    print("5. serial vs pipelined engine under memory pressure "
          "(cache << working set; DESIGN.md §7)")
    plan2 = store.load_plan()
    disk = sum(store.tile_disk_bytes(t) for t in range(plan2.num_tiles))
    pressed = dict(num_servers=4, cache_capacity_bytes=int(disk * 0.15) // 4,
                   cache_mode=3, tile_skipping=False, max_supersteps=10,
                   device=dev)
    runs = {}
    for pipe in (False, True):
        eng_c = OutOfCoreEngine(store, EngineConfig(
            pipeline=pipe, prefetch_depth=4, stack_size=4, **pressed))
        runs[pipe] = eng_c.run(PageRank(update_tol=1e-9))
    ser, pip = runs[False], runs[True]
    same = np.array_equal(ser.values, pip.values)
    print(f"   serial    {ser.mean_superstep_seconds()*1000:5.0f} ms/superstep, "
          f"disk-stall {ser.disk_stall_fraction()*100:.0f}%")
    print(f"   pipelined {pip.mean_superstep_seconds()*1000:5.0f} ms/superstep, "
          f"disk-stall {pip.disk_stall_fraction()*100:.0f}%, "
          f"bit-identical to serial: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
