"""Graph analytics driver for the port — run a GraphH app out of core.

    PYTHONPATH=src python -m repro_torch.launch.graph --app pagerank \
        --vertices 100000 --edges 1000000 --servers 4 --supersteps 20

The batch flags of ``repro.launch.graph`` for the port so far — the
in-process engine, serial or ``--pipeline``, all eight apps (``ppr``,
``msbfs`` and ``landmarks`` run ``--queries``/``--seeds`` query columns in
one edge pass, and ``--admit`` splices more in mid-run), the cache
policies, the out-of-core vertex state (``--vertex-memory-budget``,
``--num-intervals``, ``--no-interval-order``), ``--cluster`` (``--servers``
as real server processes, ``launch/cluster.py``, over ``--transport``,
with ``--steal`` and ``--verify-clean``) — plus ``--device`` (default
``cuda``).  The reference's other flags are accepted and rejected with
``NotImplementedError`` naming their ROADMAP.md queue item.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np

from repro_torch.core.apps import APPS
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.core.gab import SEG_IMPLS
from repro_torch.graphio import spe, synth
from repro_torch.graphio.formats import TileStore
from repro_torch.launch.cluster import parse_admit_plan

# reference flags outside the slice -> the ROADMAP.md queue item bringing them
_LATER_FLAGS = {
    "kernel_autotune": "A.12", "checkpoint_dir": "A.10",
    "resume": "A.10", "preemptible": "A.10", "inject": "A.10",
    "serve": "A.11", "serve_http": "A.11",
}


# batched app -> its program's query field
_QUERY_FIELD = {"ppr": "seeds", "msbfs": "sources", "landmarks": "landmarks"}


def build_store(args) -> TileStore:
    """SPE-preprocess the synthetic graph selected by the CLI namespace
    into a (new or ``--store``-named) TileStore; weighted edges are
    generated iff the app consumes them (sssp/landmarks)."""
    store = TileStore(args.store or tempfile.mkdtemp(prefix="graphh_"),
                      disk_mode=args.disk_mode)
    gen = {"rmat": synth.rmat_edges, "uniform": synth.uniform_edges,
           "banded": synth.banded_edges}[args.graph]
    weighted = args.app in ("sssp", "landmarks")
    t0 = time.time()
    spe.preprocess(
        lambda: gen(args.vertices, args.edges, seed=args.seed,
                    weighted=weighted),
        args.vertices, store, tile_size=args.tile_size,
        weighted=weighted,
    )
    print(f"SPE preprocessing: {time.time()-t0:.1f}s -> {store.root}")
    return store


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the CLI flags; reject the reference's flags outside the slice
    with ``NotImplementedError``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="pagerank", choices=sorted(APPS))
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "uniform", "banded"])
    ap.add_argument("--vertices", type=int, default=100_000)
    ap.add_argument("--edges", type=int, default=1_000_000)
    ap.add_argument("--tile-size", type=int, default=65536)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--supersteps", type=int, default=30)
    ap.add_argument("--cache-mb", type=float, default=1024)
    ap.add_argument("--cache-mode", default="auto",
                    choices=["auto", "1", "2", "3", "4"])
    ap.add_argument("--cache-policy", default="lru",
                    choices=["lru", "tiered", "cost-aware"],
                    help="lru = paper's whole-cache single mode; tiered / "
                         "cost-aware = per-tile hot/warm/cold ladder with "
                         "demote-before-evict")
    ap.add_argument("--cache-promote-hits", type=int, default=2,
                    help="hits between tier promotions (tiered policies)")
    ap.add_argument("--static-order", action="store_true",
                    help="disable cache-hit-first tile ordering")
    ap.add_argument("--comm-mode", default="hybrid",
                    choices=["dense", "sparse", "hybrid"])
    ap.add_argument("--disk-mode", type=int, default=1)
    ap.add_argument("--store", default=None,
                    help="reuse an existing tile store directory")
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap tile I/O, compute, and broadcast "
                         "compression")
    ap.add_argument("--prefetch-depth", type=int, default=4)
    ap.add_argument("--prefetch-workers", type=int, default=2)
    ap.add_argument("--stack-size", type=int, default=4,
                    help="tiles per stacked dispatch (pipelined mode)")
    ap.add_argument("--queries", type=int, default=None,
                    help="batched apps (ppr/msbfs/landmarks): number of "
                         "query instances to run in one edge pass; seeds "
                         "are drawn deterministically from --seed unless "
                         "--seeds is given")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seed/source/landmark vertex ids "
                         "for the batched apps, e.g. --seeds 0,17,42")
    ap.add_argument("--vertex-memory-budget", type=float, default=None,
                    metavar="MB",
                    help="byte budget (in MB) of the interval-sharded "
                         "out-of-core vertex state; [V,Q] arrays beyond it "
                         "spill to a disk tier.  Default: fully resident "
                         "(the paper's All-in-All)")
    ap.add_argument("--num-intervals", type=int, default=0,
                    help="source intervals K of the out-of-core vertex "
                         "state (0 = auto from the budget / stored plan)")
    ap.add_argument("--no-interval-order", action="store_true",
                    help="disable interval-aware tile co-scheduling under "
                         "out-of-core vertex state (cache-hit-first then)")
    ap.add_argument("--admit", action="append", default=None,
                    metavar="SS:SEEDS",
                    help="scripted mid-run admission for batched apps, "
                         "repeatable: '4:17,42' splices those query seeds "
                         "into [V,Q] columns at the end of superstep 4")
    ap.add_argument("--seg-impl", default="fused", choices=list(SEG_IMPLS),
                    help="fused: the fused gather→combine→apply kernel (the "
                         "segment kernel for apps without a fused form); "
                         "segment: the app's gather/apply around the "
                         "segment kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device the tiles compute on (cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--cluster", action="store_true",
                    help="run --servers as N real server processes "
                         "exchanging updates over --transport instead of "
                         "emulating them in one process")
    ap.add_argument("--transport", default="shm", choices=["shm", "tcp"],
                    help="cluster transport: shared-memory ring (one "
                         "host) or TCP sockets (rendezvous via a shared "
                         "filesystem)")
    ap.add_argument("--steal", action="store_true",
                    help="cluster mode: cross-server tile stealing "
                         "between supersteps (runtime.scheduler)")
    ap.add_argument("--verify-clean", action="store_true",
                    help="cluster mode: diff the run against a "
                         "single-process rerun")
    for flag in ("--kernel-autotune", "--resume",
                 "--preemptible", "--serve", "--serve-http"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inject", action="append", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    later = [f"--{k.replace('_', '-')} is ROADMAP.md queue {item}"
             for k, item in _LATER_FLAGS.items() if getattr(args, k)]
    if later:
        raise NotImplementedError("; ".join(later))
    return args


def _cluster_argv(args) -> list[str]:
    """The ``launch/cluster.py`` command line for a ``--cluster`` run."""
    argv = ["--app", args.app, "--graph", args.graph,
            "--vertices", str(args.vertices), "--edges", str(args.edges),
            "--tile-size", str(args.tile_size),
            "--servers", str(args.servers), "--transport", args.transport,
            "--supersteps", str(args.supersteps),
            "--comm-mode", args.comm_mode, "--cache-mb", str(args.cache_mb),
            "--cache-mode", str(args.cache_mode),
            "--cache-policy", args.cache_policy,
            "--cache-promote-hits", str(args.cache_promote_hits),
            "--prefetch-depth", str(args.prefetch_depth),
            "--prefetch-workers", str(args.prefetch_workers),
            "--stack-size", str(args.stack_size),
            "--num-intervals", str(args.num_intervals),
            "--disk-mode", str(args.disk_mode), "--seed", str(args.seed),
            "--seg-impl", args.seg_impl, "--device", args.device]
    for flag, on in (("--steal", args.steal), ("--pipeline", args.pipeline),
                     ("--static-order", args.static_order),
                     ("--no-interval-order", args.no_interval_order),
                     ("--reuse", args.reuse),
                     ("--verify-clean", args.verify_clean)):
        if on:
            argv.append(flag)
    for spec in args.admit or ():
        argv += ["--admit", spec]
    if args.store:
        argv += ["--store", args.store]
    if args.queries:
        argv += ["--queries", str(args.queries)]
    if args.seeds:
        argv += ["--seeds", args.seeds]
    if args.vertex_memory_budget is not None:
        argv += ["--vertex-memory-budget", str(args.vertex_memory_budget)]
    return argv


def main(argv=None):
    """Parse CLI flags, build or reuse a tile store, and run the selected
    app through the port's out-of-core engine (``--cluster``: through
    ``launch/cluster.py``'s N server processes)."""
    args = parse_args(argv)
    if args.cluster:
        from repro_torch.launch import cluster as cluster_mod

        return cluster_mod.main(_cluster_argv(args))
    batched = args.app in _QUERY_FIELD
    if not batched and (args.queries or args.seeds):
        raise SystemExit(f"--queries/--seeds only apply to batched apps "
                         f"(ppr/msbfs/landmarks), not {args.app}")
    if args.reuse and args.store:
        store = TileStore(args.store)
        store.load_meta()
    else:
        store = build_store(args)

    cfg = EngineConfig(
        num_servers=args.servers,
        cache_capacity_bytes=int(args.cache_mb * 1e6),
        cache_mode=args.cache_mode if args.cache_mode == "auto"
        else int(args.cache_mode),
        comm_mode=args.comm_mode,
        cache_policy=args.cache_policy,
        cache_promote_hits=args.cache_promote_hits,
        cache_aware_order=not args.static_order,
        seg_impl=args.seg_impl,
        max_supersteps=args.supersteps,
        pipeline=args.pipeline,
        prefetch_depth=args.prefetch_depth,
        prefetch_workers=args.prefetch_workers,
        stack_size=args.stack_size,
        vertex_memory_budget=(None if args.vertex_memory_budget is None
                              else int(args.vertex_memory_budget * 1e6)),
        num_intervals=args.num_intervals,
        interval_aware_order=not args.no_interval_order,
        device=args.device,
    )
    if args.admit:
        cfg = dataclasses.replace(cfg,
                                  admit_plan=parse_admit_plan(args.admit))
    eng = OutOfCoreEngine(store, cfg)
    if batched:
        if args.seeds:
            seeds = tuple(int(s) for s in args.seeds.split(","))
        else:
            rng = np.random.default_rng(args.seed)
            seeds = tuple(int(v) for v in rng.choice(
                args.vertices, size=args.queries or 8, replace=False))
        prog = APPS[args.app](**{_QUERY_FIELD[args.app]: seeds})
    else:
        prog = APPS[args.app]()
    t0 = time.time()
    res = eng.run(prog)
    dt = time.time() - t0
    print(f"{args.app}: {res.supersteps} supersteps in {dt:.1f}s "
          f"(mean {res.mean_superstep_seconds()*1000:.0f} ms/superstep, "
          f"converged={res.converged}, device={eng.device})")
    if batched:
        q = len(seeds)
        io = sum(x.disk_bytes_read for x in res.history)
        print(f"  {q} queries in one edge pass: "
              f"tile I/O {io/1e6:.1f} MB total = {io/q/1e6:.2f} MB/query, "
              f"{dt/q*1000:.0f} ms/query; per-query supersteps "
              f"{[int(s) for s in res.per_query_supersteps]}")
    h = res.history[-1]
    print(f"  cache hit ratio {h.cache_hit_ratio:.2f}, "
          f"net {sum(x.network_bytes for x in res.history)/1e6:.1f} MB total, "
          f"mode={eng.cache_mode}, "
          f"disk-stall {res.disk_stall_fraction()*100:.0f}% of wall time"
          f"{' (pipelined)' if args.pipeline else ''}")
    if args.vertex_memory_budget is not None:
        vs = eng.vstate.stats
        faults = sum(x.vstate_faults for x in res.history)
        spill = sum(x.vstate_spill_bytes for x in res.history)
        load = sum(x.vstate_load_bytes for x in res.history)
        print(f"  vertex state [{eng.vstate.num_intervals} intervals, "
              f"budget {args.vertex_memory_budget:g} MB]: "
              f"{faults} interval faults, {load/1e6:.1f} MB faulted in, "
              f"{spill/1e6:.1f} MB spilled to disk, "
              f"{vs.dirty_writebacks} dirty writebacks")
    if args.cache_policy != "lru":
        promo = sum(x.cache_promotions for x in res.history)
        demo = sum(x.cache_demotions for x in res.history)
        tiers = ", ".join(
            f"{name}: {d['tiles']} tiles/{d['bytes']/1e6:.1f} MB "
            f"({d['hits']} hits)"
            for name, d in sorted(h.cache_tiers.items()))
        print(f"  cache tiers [{args.cache_policy}]: {tiers or 'empty'}; "
              f"{promo} promotions, {demo} demotions")
    return res


if __name__ == "__main__":
    main()
