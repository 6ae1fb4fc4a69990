"""Graph analytics driver for the port — run a GraphH app out of core.

    PYTHONPATH=src python -m repro_torch.launch.graph --app pagerank \
        --vertices 100000 --edges 1000000 --servers 4 --supersteps 20

The flags of ``repro.launch.graph`` for the port so far — the in-process
engine, serial or ``--pipeline``, all eight apps (``ppr``, ``msbfs`` and
``landmarks`` run ``--queries``/``--seeds`` query columns in one edge
pass, and ``--admit`` splices more in mid-run), the cache policies, the
out-of-core vertex state (``--vertex-memory-budget``, ``--num-intervals``,
``--no-interval-order``), ``--cluster`` (``--servers`` as real server
processes, ``launch/cluster.py``, over ``--transport``, with ``--steal``
and ``--verify-clean``), superstep checkpoints and fault drills
(``--checkpoint-dir``, ``--checkpoint-every``, ``--resume``,
``--preemptible``, ``--inject``; ``--on-failure`` and ``--max-restarts``
supervise a ``--cluster``), and the online query service (``--serve``,
``--serve-http`` and their flags, ``serve/graph_service.py``,
``serve/http.py``) and ``--kernel-autotune`` (the kernels' blocks and
the pipelined stack size from ``roofline/kernel_tune.py``, in each mode)
— plus ``--device`` (default ``cuda``).  ``--seg-impl`` also takes the
reference's names.
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
from repro_torch.runtime.faults import parse_plan

# reference flags outside the port -> the ROADMAP.md queue item bringing
# them (none since A.12)
_LATER_FLAGS: dict[str, str] = {}

# the reference's --seg-impl backends -> the port's: "jnp" reduces and then
# applies, as "segment" does; "pallas_onehot" is the segment kernel
_REFERENCE_SEG_IMPLS = {"jnp": "segment", "pallas_onehot": "segment",
                        "pallas_fused": "fused"}


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
    ap.add_argument("--seg-impl", default="fused",
                    choices=list(SEG_IMPLS) + list(_REFERENCE_SEG_IMPLS),
                    help="fused: the fused gather→combine→apply kernel (the "
                         "segment kernel for apps without a fused form); "
                         "segment: the app's gather/apply around the "
                         "segment kernel; the reference's names map onto "
                         "them (jnp, pallas_onehot: segment; pallas_fused: "
                         "fused)")
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
    ap.add_argument("--checkpoint-dir", default=None,
                    help="superstep-boundary checkpoints here; enables "
                         "--resume")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint every K superstep boundaries "
                         "(0 = final checkpoint only)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint "
                         "(bit-identical; --servers may differ from the "
                         "saved run)")
    ap.add_argument("--preemptible", action="store_true",
                    help="SIGTERM => save at the next superstep boundary "
                         "and exit for later --resume")
    ap.add_argument("--on-failure", default="fail",
                    choices=["fail", "restart", "shrink"],
                    help="cluster mode: rank-death policy (restart/shrink "
                         "resume from --checkpoint-dir)")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--inject", action="append", default=None,
                    metavar="SPEC",
                    help="fault-injection spec (runtime.faults), "
                         "repeatable — fault drills only")
    ap.add_argument("--verify-clean", action="store_true",
                    help="cluster mode: diff the run against an "
                         "uninterrupted single-process rerun")
    ap.add_argument("--serve", action="store_true",
                    help="run as a long-lived graph-query service: queries "
                         "admit into retired [V,Q] slots mid-run; SIGTERM "
                         "drains gracefully")
    ap.add_argument("--q-slots", type=int, default=8,
                    help="serve mode: live query columns per session")
    ap.add_argument("--min-fill", type=int, default=1,
                    help="serve mode: batch admissions until this many "
                         "queries are queued (amortizes the all-dirty "
                         "superstep an admission forces) ...")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="... but admit anyway after this long")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="serve mode: per-query deadline; overdue "
                         "queries drain with partial results")
    ap.add_argument("--serve-requests", type=int, default=32,
                    help="serve mode: scripted workload size "
                         "(0 = serve idle until SIGTERM)")
    ap.add_argument("--serve-qps", type=float, default=0.0,
                    help="serve mode: offered arrival rate for the "
                         "scripted workload (0 = submit all upfront)")
    ap.add_argument("--serve-apps", default="ppr,msbfs",
                    help="serve mode: comma list of batched apps the "
                         "scripted workload mixes")
    ap.add_argument("--drain-mode", default="finish",
                    choices=["finish", "checkpoint"],
                    help="serve mode: on SIGTERM, run in-flight queries "
                         "to convergence or checkpoint them for a "
                         "--resume'd service restart")
    ap.add_argument("--serve-http", action="store_true",
                    help="serve mode with the JSON-over-HTTP frontend "
                         "(serve/http.py): POST /v1/query, GET "
                         "/v1/query/<rid>, /v1/stats, /healthz; implies "
                         "--serve and idles until SIGTERM")
    ap.add_argument("--host", default="127.0.0.1",
                    help="HTTP frontend bind address")
    ap.add_argument("--port", type=int, default=8080,
                    help="HTTP frontend port (0 = ephemeral; the bound "
                         "port is printed as 'serving http on ...')")
    ap.add_argument("--tenants", default=None, metavar="NAME:W,...",
                    help="serve mode: tenant weights for deficit-round-"
                         "robin fair admission, e.g. 'alice:3,bob:1' "
                         "(unknown tenants serve at weight 1)")
    ap.add_argument("--result-cache", type=int, default=0,
                    metavar="ENTRIES",
                    help="serve mode: exact result-cache capacity keyed "
                         "by (app, seed, graph fingerprint); repeated "
                         "seeds return without consuming a [V,Q] slot "
                         "(0 = off)")
    ap.add_argument("--drain-linger-ms", type=float, default=500.0,
                    help="HTTP serve mode: keep GET /v1/query/<rid> "
                         "answering this long after the drain so "
                         "clients can collect in-flight results")
    ap.add_argument("--kernel-autotune", action="store_true",
                    help="pick the GAB kernels' (block_e, block_r) and the "
                         "pipelined stack size from the card's cost model "
                         "(roofline/kernel_tune.py); results are "
                         "bit-identical to the static blocks")
    args = ap.parse_args(argv)
    args.seg_impl = _REFERENCE_SEG_IMPLS.get(args.seg_impl, args.seg_impl)
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
            "--seg-impl", args.seg_impl, "--device", args.device,
            "--checkpoint-every", str(args.checkpoint_every),
            "--on-failure", args.on_failure,
            "--max-restarts", str(args.max_restarts)]
    for flag, on in (("--steal", args.steal), ("--pipeline", args.pipeline),
                     ("--static-order", args.static_order),
                     ("--no-interval-order", args.no_interval_order),
                     ("--reuse", args.reuse), ("--resume", args.resume),
                     ("--preemptible", args.preemptible),
                     ("--verify-clean", args.verify_clean),
                     ("--kernel-autotune", args.kernel_autotune)):
        if on:
            argv.append(flag)
    if args.checkpoint_dir:
        argv += ["--checkpoint-dir", args.checkpoint_dir]
    for spec in args.inject or ():
        argv += ["--inject", spec]
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


def _serve_main(args):
    """``--serve`` / ``--serve-http``: long-lived graph-query service
    over the tile store.  A scripted workload of ``--serve-requests``
    mixed queries (seeded from ``--seed``) is offered at ``--serve-qps``
    (0 = all upfront) from a feeder thread; the serve loop runs in the
    main thread so SIGTERM drains gracefully (exit 0).  With
    ``--serve-requests 0`` — always in HTTP mode — the service idles until
    SIGTERM.  ``--serve-http`` additionally binds the JSON-over-HTTP
    frontend (serve/http.py) on ``--host``/``--port`` and keeps it
    answering ``GET /v1/query/<rid>`` for ``--drain-linger-ms`` after the
    drain so clients can collect in-flight results.  The engines compute
    on ``--device`` with ``--seg-impl``."""
    import threading

    from repro_torch.serve.graph_service import (SERVABLE, GraphService,
                                                 parse_tenants)

    apps = [a.strip() for a in args.serve_apps.split(",") if a.strip()]
    bad = [a for a in apps if a not in SERVABLE]
    if bad:
        raise SystemExit(f"--serve-apps: {bad} not servable "
                         f"(batched apps only: {', '.join(SERVABLE)})")
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
        seg_impl=args.seg_impl,
        pipeline=args.pipeline,
        vertex_memory_budget=(None if args.vertex_memory_budget is None
                              else int(args.vertex_memory_budget * 1e6)),
        num_intervals=args.num_intervals,
        checkpoint_dir=args.checkpoint_dir,
        kernel_autotune=args.kernel_autotune,
        device=args.device,
    )
    svc = GraphService(
        store, cfg, q_slots=args.q_slots, min_fill=args.min_fill,
        max_wait_s=args.max_wait_ms / 1e3,
        default_deadline_s=(None if args.deadline_ms is None
                            else args.deadline_ms / 1e3),
        max_supersteps=args.supersteps,
        drain_mode=args.drain_mode, resume=args.resume,
        tenants=parse_tenants(args.tenants) if args.tenants else None,
        result_cache=args.result_cache)

    frontend = None
    if args.serve_http:
        from repro_torch.serve.http import HttpFrontend

        plan = parse_plan(args.inject)
        frontend = HttpFrontend(
            svc, host=args.host, port=args.port,
            fault=None if plan is None else plan.injector()).start()
        print(f"serving http on {frontend.host}:{frontend.port}",
              flush=True)

    def feeder():
        # seeds are drawn below the store's vertex count (a reused store
        # may hold fewer vertices than --vertices)
        rng = np.random.default_rng(args.seed)
        tickets = []
        for i in range(args.serve_requests):
            if args.serve_qps > 0 and i:
                time.sleep(1.0 / args.serve_qps)
            try:
                tickets.append(svc.submit(apps[i % len(apps)],
                                          int(rng.integers(
                                              svc.num_vertices))))
            except RuntimeError:
                break               # service started draining under us
        for t in tickets:
            t.wait()
        svc.request_drain()

    if args.serve_requests and not args.serve_http:
        threading.Thread(target=feeder, daemon=True).start()
    print(f"serving {','.join(apps)} on {store.root} "
          f"(q_slots={args.q_slots}, min_fill={args.min_fill}, "
          f"max_wait={args.max_wait_ms:g} ms, drain={args.drain_mode}, "
          f"device={svc.cfg.device})", flush=True)
    t0 = time.time()
    svc.serve()
    dt = time.time() - t0
    if frontend is not None:
        # linger: finished tickets stay pollable while clients collect
        time.sleep(max(0.0, args.drain_linger_ms) / 1e3)
        frontend.close()
    s = svc.latency_summary()
    print(f"drained: {svc.stats['done']} done, {svc.stats['timeout']} "
          f"timeout, {svc.stats['failed']} failed, "
          f"{svc.stats['refused']} refused in {dt:.1f}s "
          f"({svc.stats['done'] / max(dt, 1e-9):.2f} queries/s, "
          f"{svc.stats['supersteps']} supersteps, "
          f"{svc.stats['sessions_opened']} sessions)")
    if s.get("count"):
        print(f"  latency p50 {s['p50_ms']:.0f} ms, p99 {s['p99_ms']:.0f} "
              f"ms (queue {s['mean_queue_ms']:.0f} ms + service "
              f"{s['mean_service_ms']:.0f} ms mean); "
              f"{s['mean_supersteps']:.1f} supersteps/query mean")
    if svc.cache is not None:
        c = svc.cache.snapshot()
        print(f"  result cache: {c['hits']} hits / {c['misses']} misses "
              f"({c['entries']}/{c['capacity']} entries)")
    if svc.tenant_stats:
        parts = ", ".join(
            f"{t}: {d['admitted']} admitted/{d['submitted']} submitted"
            for t, d in sorted(svc.tenant_stats.items()))
        print(f"  tenants: {parts}")
    if args.kernel_autotune:
        for app, eng in sorted(svc._engines.items()):
            for (combine, q), c in sorted(eng._kernel_choices.items()):
                print(f"  {app} " + autotune_line(combine, q, c))
    return svc


def autotune_line(combine: str, q: int, c) -> str:
    """The reference's line for a tuner pick ``c`` (a ``KernelChoice``)."""
    return (f"kernel autotune [{combine}, Q={q}]: BE={c.block_e} "
            f"BR={c.block_r} stack={c.stack_size} ({c.bound}-bound, "
            f"ceiling {c.edges_per_s:.2e} edges/s)")


def main(argv=None):
    """Parse CLI flags, build or reuse a tile store, and run the selected
    app through the port's out-of-core engine (``--serve``/``--serve-http``:
    the online query service; ``--cluster``: ``launch/cluster.py``'s N
    server processes)."""
    args = parse_args(argv)
    if args.serve or args.serve_http:
        return _serve_main(args)
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
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        preemptible=args.preemptible,
        fault_plan=parse_plan(args.inject),
        kernel_autotune=args.kernel_autotune,
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
    if args.kernel_autotune and eng.kernel_choice is not None:
        print("  " + autotune_line(prog.combine,
                                   getattr(prog, "num_queries", 1),
                                   eng.kernel_choice))
    if batched:
        q = len(seeds)
        io = sum(x.disk_bytes_read for x in res.history)
        print(f"  {q} queries in one edge pass: "
              f"tile I/O {io/1e6:.1f} MB total = {io/q/1e6:.2f} MB/query, "
              f"{dt/q*1000:.0f} ms/query; per-query supersteps "
              f"{[int(s) for s in res.per_query_supersteps]}")
    if not res.history:
        # --resume of a final checkpoint returns the stored result without
        # running a superstep: there are no per-superstep stats
        print("  resumed a finished run from its final checkpoint "
              "(no supersteps executed)")
        return res
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
