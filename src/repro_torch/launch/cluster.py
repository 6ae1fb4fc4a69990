"""Multi-process cluster launcher of the port — real N-server GraphH runs
(DESIGN.md §11).

    PYTHONPATH=src python -m repro_torch.launch.cluster --app pagerank \
        --vertices 100000 --edges 1000000 --servers 4 --transport shm

Spawns N server processes (multiprocessing ``spawn``, never ``fork``: a
parent with CUDA state or threads cannot fork safely), each running the
out-of-core engine (``engine.OutOfCoreEngine`` with ``server_rank``) over
its stage-2 tile share of one shared TileStore, and exchanging
per-superstep vertex updates through a real transport
(``core.transport``: shared-memory ring, or TCP sockets via
``--transport tcp``).  Results are bit-identical to the single-process
engine — the launcher verifies this across ranks on every run.

Every rank computes on ``ClusterConfig.device``: with ``"cuda"`` rank r
takes card ``r % torch.cuda.device_count()``, so N ranks may share one
card (the transport is on the host); the parent builds the kernels once
before spawning, and raises when it sees no card.  Results come back
through the pipe as numpy.

A single launch amortizes process startup over many programs: pass
several vertex programs and the same N servers execute them back to back
(the exchange sequence numbers keep the BSP barriers aligned across runs).

Supervised restart and shrink (``on_failure``), checkpoints, resume,
preemption and fault injection are ROADMAP.md queue A.10: those knobs
raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, OutOfCoreEngine


@dataclasses.dataclass
class ClusterConfig:
    """Knobs for a multi-process cluster run (engine knobs ride along in
    ``engine`` — its ``num_servers``/``server_rank``/``device`` are
    overridden per spawned process)."""

    num_servers: int = 2
    #: "shm" = mmap shared-memory ring per server pair (single host);
    #: "tcp" = sockets with file rendezvous (works across hosts sharing
    #: only a filesystem)
    transport: str = "shm"
    #: per-directed-channel ring capacity in bytes (shm transport)
    ring_capacity: int = 1 << 22
    #: cross-server tile stealing between supersteps (scheduler.
    #: rebalance_assignment); requires engine_mode="tiled"
    steal: bool = False
    straggler_factor: float = 1.5
    #: per-superstep exchange timeout inside each server (seconds)
    timeout_seconds: float = 180.0
    #: parent-side timeout for the whole launch (seconds)
    launch_timeout_seconds: float = 900.0
    #: where every rank computes: "cuda" (rank r on card r mod the card
    #: count) or "cpu" (the kernels' plain versions, the tests)
    device: str = "cuda"
    #: what to do when a rank dies: "fail" = raise ClusterFailure;
    #: "restart"/"shrink" are ROADMAP.md queue A.10
    on_failure: str = "fail"
    #: supervised restart budget (ROADMAP.md queue A.10)
    max_restarts: int = 2
    #: engine template; num_servers/server_rank/device are set per rank
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    def unsupported(self) -> list[str]:
        """The knobs set outside the port so far, each with the ROADMAP.md
        queue item that will bring it (the engine's own included)."""
        out = list(self.engine.unsupported())
        if self.on_failure != "fail":
            out.append(f"on_failure={self.on_failure!r} (supervised "
                       "restart/shrink) is ROADMAP.md queue A.10")
        if self.max_restarts != ClusterConfig.max_restarts:
            out.append("max_restarts is ROADMAP.md queue A.10")
        return out


class ClusterFailure(RuntimeError):
    """A cluster attempt died: one or more ranks failed or were killed.
    Carries ``dead_ranks`` and ``pids`` (of every spawned rank, dead or
    reaped) for the caller and the tests."""

    def __init__(self, message: str, dead_ranks=(), pids=()):
        super().__init__(message)
        self.dead_ranks = list(dead_ranks)
        self.pids = list(pids)


@dataclasses.dataclass
class ClusterResult:
    """Parent-side result of :func:`run_cluster`."""

    results: list            # rank 0's RunResult per program
    #: one dict per rank: seconds, wire/raw bytes sent, steals, final
    #: assignment, the exchange's seconds per phase for each program,
    #: kernel launches and device memory
    rank_reports: list
    # final values bit-identical across all ranks; always True on a
    # returned result (run_cluster RAISES on divergence), kept so callers
    # can assert the invariant explicitly
    verified: bool
    #: every rank's RunResult per program ([rank][program])
    rank_results: list = dataclasses.field(default_factory=list)

    def wire_bytes_per_superstep(self, app_index: int = 0) -> list:
        """Cluster-total measured wire bytes per superstep for one app."""
        return [h.wire_bytes for h in self.results[app_index].history]


def _rank_device(device: str, rank: int) -> str:
    """The device rank ``rank`` computes on: an indexed device as given,
    bare ``"cuda"`` as card ``rank % device_count``."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return f"cuda:{rank % torch.cuda.device_count()}"
    return device


def _launch_counts() -> dict:
    """Every kernel wrapper's launch counter in this process."""
    from repro_torch.kernels import compact, gab_fused, gab_gather

    return {"segment_reduce": gab_gather.LAUNCHES,
            "gab_fused": gab_fused.LAUNCHES, "compact": compact.LAUNCHES}


def _device_memory(device: str) -> dict:
    """This rank's torch allocator peak and, for a card, the bytes in use
    on the whole card (every rank's context and hub scratch included)."""
    d = torch.device(device)
    if d.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(d)
    return dict(torch_reserved_bytes=torch.cuda.memory_reserved(d),
                torch_peak_bytes=torch.cuda.max_memory_allocated(d),
                card_used_bytes=total - free)


def _server_main(rank: int, store_root: str, cfg: ClusterConfig,
                 progs: list, run_dir: str, conn) -> None:
    """Entry point of one spawned server process: build transport +
    exchange + engine for ``rank``, run every program, ship results back
    through ``conn``.  Errors are reported (never silently dropped) so the
    parent can tear the cluster down."""
    from repro_torch.core import transport as transport_mod
    from repro_torch.core.distributed import ClusterExchange
    from repro_torch.graphio.formats import TileStore

    transport = None
    exchange = None
    try:
        # N ranks share the host: each takes its share of the cores for
        # torch's intra-op threads (oversubscribed spinning threads slow a
        # CPU rank's tile math by two orders of magnitude)
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // cfg.num_servers))
        store = TileStore(store_root)
        store.load_meta()
        device = _rank_device(cfg.device, rank)
        ecfg = dataclasses.replace(
            cfg.engine, num_servers=cfg.num_servers, server_rank=rank,
            device=device)
        if cfg.steal and ecfg.engine_mode != "tiled":
            raise ValueError("tile stealing requires engine_mode='tiled' "
                             "(stacked/merged pin tiles to devices)")
        eng = OutOfCoreEngine(store, ecfg)
        transport = transport_mod.make_transport(
            cfg.transport, rank, cfg.num_servers, run_dir)
        exchange = ClusterExchange(
            transport, comm_mode=ecfg.comm_mode,
            compressor=ecfg.comm_compressor, threshold=ecfg.comm_threshold,
            assignment=eng.assignment,
            edges_per_tile=eng.plan.edges_per_tile,
            steal=cfg.steal, straggler_factor=cfg.straggler_factor,
            timeout=cfg.timeout_seconds)
        eng.exchange = exchange
        launches0 = _launch_counts()
        results, split = [], []
        t0 = time.perf_counter()
        for prog in progs:
            before = dict(exchange.seconds)
            results.append(eng.run(prog))
            split.append({k: v - before[k]
                          for k, v in exchange.seconds.items()})
        seconds = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
        report = dict(
            rank=rank,
            device=device,
            seconds=seconds,
            # what THIS rank put on the wire (cluster totals live in the
            # per-superstep history of every rank's RunResult)
            wire_bytes=exchange.sent_wire_bytes,
            raw_bytes=exchange.sent_raw_bytes,
            steal_moves=exchange.steal_moves,
            final_assignment=[list(a) for a in eng.assignment],
            # the exchange's seconds per phase, one dict per program
            exchange_seconds=split,
            launches=launches,
            **_device_memory(device),
        )
        conn.send(("ok", results, report))
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc(), None))
        except (OSError, ValueError):
            pass
        raise SystemExit(1)
    finally:
        if exchange is not None:
            exchange.close()
        if transport is not None:
            transport.close()
        conn.close()


def _teardown(procs) -> None:
    """Bounded-time teardown: terminate, then escalate to SIGKILL.

    A rank blocked inside a transport recv can ignore SIGTERM for the
    socket timeout; the kill escalation guarantees no child outlives the
    parent by more than ~10s and none leaks."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=5.0)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)


def _run_attempt(store_root: str, progs: list, cfg: ClusterConfig,
                 run_dir: str) -> ClusterResult:
    """Spawn N ranks, collect their results, raise ClusterFailure (after
    bounded teardown) when any rank dies or errors."""
    from repro_torch.core import transport as transport_mod

    n = cfg.num_servers
    if cfg.transport == "shm":
        transport_mod.create_ring_files(run_dir, n, cfg.ring_capacity)

    ctx = mp.get_context("spawn")
    procs, conns = [], []
    try:
        for rank in range(n):
            parent_conn, child_conn = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_server_main,
                args=(rank, store_root, cfg, progs, run_dir, child_conn),
                name=f"graphh-server-{rank}", daemon=True)
            p.start()
            child_conn.close()
            procs.append(p)
            conns.append(parent_conn)

        pids = [p.pid for p in procs]
        deadline = time.monotonic() + cfg.launch_timeout_seconds
        payloads: list = [None] * n
        pending = set(range(n))
        while pending:
            for r in sorted(pending):
                if conns[r].poll(0.1):
                    try:
                        payloads[r] = conns[r].recv()
                    except EOFError:
                        raise ClusterFailure(
                            f"cluster server {r} died (exit code "
                            f"{procs[r].exitcode}) without reporting",
                            dead_ranks=[r], pids=pids)
                    pending.discard(r)
                    if payloads[r][0] == "error":
                        # fail fast: peers are now blocked on this rank's
                        # missing frames; the finally below reaps them
                        raise ClusterFailure(
                            f"cluster server {r} failed:\n{payloads[r][1]}",
                            dead_ranks=[r], pids=pids)
                elif not procs[r].is_alive() and not conns[r].poll(0.1):
                    raise ClusterFailure(
                        f"cluster server {r} died (exit code "
                        f"{procs[r].exitcode}) without reporting",
                        dead_ranks=[r], pids=pids)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"cluster launch timed out; pending ranks {sorted(pending)}")
        for p in procs:
            p.join(timeout=30.0)
    finally:
        _teardown(procs)

    all_results = [payloads[r][1] for r in range(n)]
    reports = [payloads[r][2] for r in range(n)]
    diverged = [(a, r) for a in range(len(progs)) for r in range(1, n)
                if not np.array_equal(all_results[0][a].values,
                                      all_results[r][a].values)]
    if diverged:
        raise RuntimeError(
            "cluster ranks diverged — final values not bit-identical for "
            f"(app index, rank): {diverged}; this is a wrong answer, not "
            "a degraded one (transport/decode bug or broken hardware)")
    return ClusterResult(results=all_results[0], rank_reports=reports,
                         verified=True, rank_results=all_results)


def run_cluster(store_root: str, progs: list,
                cfg: ClusterConfig = ClusterConfig(),
                run_dir: Optional[str] = None,
                keep_run_dir: bool = False) -> ClusterResult:
    """Run ``progs`` (VertexProgram instances) on an N-server cluster over
    the tile store at ``store_root``.

    The parent creates the rendezvous directory (+ shared-memory ring
    files for the shm transport), builds the CUDA kernels once when the
    ranks compute on a card, spawns the N server processes, collects each
    rank's results, verifies the final value arrays are bit-identical
    across ranks (divergence RAISES — a divergent cluster run is a wrong
    answer, never a degraded one), and returns rank 0's results with
    per-rank reports.  Any rank failure tears the cluster down and raises
    ClusterFailure with that rank's traceback."""
    problems = cfg.unsupported()
    if problems:
        raise NotImplementedError("; ".join(problems))
    if torch.device(cfg.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {cfg.device!r} requested but "
                               "PyTorch sees no CUDA device")
        from repro_torch.kernels import _build

        _build.build()    # once here, not N concurrent nvcc runs
    base_dir = run_dir or tempfile.mkdtemp(prefix="graphh_cluster_")
    own_dir = run_dir is None
    try:
        attempt_dir = os.path.join(base_dir, "attempt_00")
        os.makedirs(attempt_dir, exist_ok=True)
        return _run_attempt(store_root, progs, cfg, attempt_dir)
    finally:
        if own_dir and not keep_run_dir:
            shutil.rmtree(base_dir, ignore_errors=True)


def parse_admit_plan(specs) -> Optional[tuple]:
    """``--admit`` specs -> ``EngineConfig.admit_plan``: each
    ``"SS:seed1,seed2"`` entry schedules those query seeds for admission
    at the end of superstep SS (batched apps only)."""
    if not specs:
        return None
    plan = []
    for spec in specs:
        try:
            ss, seeds = spec.split(":", 1)
            plan.append((int(ss), tuple(int(s)
                                        for s in seeds.split(","))))
        except ValueError:
            raise SystemExit(f"--admit {spec!r}: expected 'SS:seed,seed'")
    return tuple(sorted(plan))


def _build_progs(args) -> list:
    """Vertex program list for the CLI (mirrors launch.graph seeding)."""
    from repro_torch.core.apps import APPS

    batched = args.app in ("ppr", "msbfs", "landmarks")
    if batched:
        if args.seeds:
            seeds = tuple(int(s) for s in args.seeds.split(","))
        else:
            q = args.queries or 8
            rng = np.random.default_rng(args.seed)
            seeds = tuple(int(v) for v in
                          rng.choice(args.vertices, size=q, replace=False))
        key = {"ppr": "seeds", "msbfs": "sources", "landmarks": "landmarks"}
        return [APPS[args.app](**{key[args.app]: seeds})]
    if args.queries or args.seeds:
        raise SystemExit(f"--queries/--seeds only apply to batched apps "
                         f"(ppr/msbfs/landmarks), not {args.app}")
    return [APPS[args.app]()]


# reference cluster flags outside the slice -> the ROADMAP.md queue item
_LATER_FLAGS = {"checkpoint_dir": "A.10", "resume": "A.10",
                "preemptible": "A.10", "inject": "A.10"}


def main(argv=None) -> ClusterResult:
    """CLI: build (or reuse) a tile store, run one app on an N-server
    cluster, print per-superstep wire bytes and per-rank reports."""
    from repro_torch.core.apps import APPS
    from repro_torch.core.partition import server_vertex_ranges
    from repro_torch.graphio.formats import TileStore
    from repro_torch.launch.graph import build_store

    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="pagerank", choices=sorted(APPS))
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "uniform", "banded"])
    ap.add_argument("--vertices", type=int, default=100_000)
    ap.add_argument("--edges", type=int, default=1_000_000)
    ap.add_argument("--tile-size", type=int, default=65536)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--transport", default="shm", choices=["shm", "tcp"])
    ap.add_argument("--steal", action="store_true",
                    help="cross-server tile stealing between supersteps")
    ap.add_argument("--supersteps", type=int, default=30)
    ap.add_argument("--comm-mode", default="hybrid",
                    choices=["dense", "sparse", "hybrid"])
    ap.add_argument("--cache-mb", type=float, default=1024)
    ap.add_argument("--cache-mode", default="auto",
                    choices=["auto", "1", "2", "3", "4"])
    ap.add_argument("--cache-policy", default="lru",
                    choices=["lru", "tiered", "cost-aware"])
    ap.add_argument("--cache-promote-hits", type=int, default=2)
    ap.add_argument("--static-order", action="store_true")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--prefetch-depth", type=int, default=4)
    ap.add_argument("--prefetch-workers", type=int, default=2)
    ap.add_argument("--stack-size", type=int, default=4)
    ap.add_argument("--num-intervals", type=int, default=0)
    ap.add_argument("--no-interval-order", action="store_true")
    ap.add_argument("--disk-mode", type=int, default=1)
    ap.add_argument("--store", default=None)
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--seeds", default=None)
    ap.add_argument("--vertex-memory-budget", type=float, default=None,
                    metavar="MB")
    ap.add_argument("--on-failure", default="fail",
                    choices=["fail", "restart", "shrink"],
                    help="rank-death policy: fail fast (restart and shrink "
                         "are ROADMAP.md queue A.10)")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--verify-clean", action="store_true",
                    help="after the cluster run, re-run in one process and "
                         "fail unless the answers are byte-for-byte "
                         "identical")
    ap.add_argument("--admit", action="append", default=None,
                    metavar="SS:SEEDS",
                    help="scripted mid-run admission for batched apps, "
                         "repeatable: '4:17,42' splices queries seeded at "
                         "vertices 17 and 42 into [V,Q] columns at the end "
                         "of superstep 4.  The plan replicates to every "
                         "rank; rank 0 admits (its frame header carries "
                         "the record) and peers splice from it")
    ap.add_argument("--seg-impl", default="fused",
                    choices=["fused", "segment"])
    ap.add_argument("--device", default="cuda",
                    help="torch device every rank computes on (cpu runs "
                         "the kernels' plain versions)")
    for flag in ("--resume", "--preemptible"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--inject", action="append", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    later = [f"--{k.replace('_', '-')} is ROADMAP.md queue {item}"
             for k, item in _LATER_FLAGS.items() if getattr(args, k)]
    if later:
        raise NotImplementedError("; ".join(later))

    if args.reuse and args.store:
        store = TileStore(args.store)
        store.load_meta()
    else:
        store = build_store(args)

    ecfg = EngineConfig(
        comm_mode=args.comm_mode,
        cache_capacity_bytes=int(args.cache_mb * 1e6),
        cache_mode=args.cache_mode if args.cache_mode == "auto"
        else int(args.cache_mode),
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
        admit_plan=parse_admit_plan(args.admit),
        device=args.device,
    )
    cfg = ClusterConfig(num_servers=args.servers, transport=args.transport,
                        steal=args.steal, on_failure=args.on_failure,
                        max_restarts=args.max_restarts, device=args.device,
                        engine=ecfg)
    progs = _build_progs(args)
    t0 = time.time()
    out = run_cluster(store.root, progs, cfg)
    dt = time.time() - t0
    res = out.results[0]
    wire = sum(h.wire_bytes for h in res.history)
    net = sum(h.network_bytes for h in res.history)
    print(f"{args.app} x{args.servers} servers [{args.transport}"
          f"{', steal' if args.steal else ''}, {args.device}]: "
          f"{res.supersteps} supersteps in {dt:.1f}s "
          f"(converged={res.converged}, "
          f"bit-identical across ranks={out.verified})")
    if args.verify_clean:
        clean_cfg = dataclasses.replace(ecfg, num_servers=args.servers)
        clean_eng = OutOfCoreEngine(store, clean_cfg)
        for i, prog in enumerate(_build_progs(args)):
            clean = clean_eng.run(prog)
            if not np.array_equal(clean.values, out.results[i].values):
                raise SystemExit(
                    f"verify-clean FAILED: app index {i} differs from the "
                    "single-process run")
        print("  verify-clean: byte-identical to the single-process run")
    print(f"  wire {wire / 1e6:.2f} MB total ({net / 1e6:.2f} MB on the "
          f"network at N-1 peers/server); per-superstep "
          f"{[h.wire_bytes for h in res.history[:8]]}"
          f"{'...' if res.supersteps > 8 else ''}")
    plan = store.load_plan()
    for rep in out.rank_reports:
        ranges = server_vertex_ranges(plan.splitter,
                                      [rep["final_assignment"][rep["rank"]]])[0]
        owned = sum(hi - lo for lo, hi in ranges)
        split = ", ".join(
            f"{k.removeprefix('exchange_')} "
            f"{sum(p[k] for p in rep['exchange_seconds']):.2f}s"
            for k in rep["exchange_seconds"][0])
        print(f"  rank {rep['rank']}: {rep['seconds']:.1f}s, "
              f"sent {rep['wire_bytes'] / 1e6:.2f} MB, "
              f"{len(rep['final_assignment'][rep['rank']])} tiles / "
              f"{owned} rows owned"
              + (f", {rep['steal_moves']} tiles stolen" if args.steal
                 else "") + f"; exchange {split}")
    return out


if __name__ == "__main__":
    main()
