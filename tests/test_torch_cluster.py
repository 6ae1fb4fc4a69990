"""The port's multi-process cluster runtime, on the CPU.

The acceptance property: an N-server cluster run is bit-identical to the
port's single-process engine — values, supersteps, per-query supersteps,
and on every rank the same per-superstep ``wire_bytes`` and
``updated_vertices`` — for every app at N in {1, 2, 4}; against the JAX
package's engine (``JAX_PLATFORMS=cpu``) the min/max apps are
``array_equal`` and PageRank/PPR within ``rtol=1e-5, atol=1e-6``.
Covered two ways, as tests/test_cluster.py does for the reference:

  * in-process "clusters" — each rank a thread with its own engine and
    ``ClusterExchange`` over a real shared-memory transport, and
  * spawned clusters through ``launch.cluster.run_cluster`` (one launch
    per N runs every app), plus one TCP + stealing launch and a rank that
    raises.

Cluster admission: rank 0's control record carries ``admit_plan``
entries and queued ``admit()`` seeds, and every rank splices them at the
barrier the single-process engine does — a slot freed by retirement
refills at that same barrier.  The JAX package is imported inside the
tests only: spawned ranks import this module and need only torch.
"""
import multiprocessing as mp
import os
import tempfile
import threading
import time
import types

import numpy as np
import pytest

from repro_torch.core import apps as tapps
from repro_torch.core import transport as T
from repro_torch.core.distributed import ClusterExchange
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio.formats import TileStore
from repro_torch.launch import graph as tgraph
from repro_torch.launch.cluster import (ClusterConfig, ClusterFailure,
                                        run_cluster)
from repro_torch.runtime.scheduler import rebalance_assignment

SS = 12   # superstep cap: keep runs cheap; parity must hold at any cap
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
EXACT_APPS = ("wcc", "msbfs", "sssp", "landmarks")


def _make_store(weighted, seed=7, nv=220, ne=1400, tile_size=96):
    from repro.graphio import spe
    from repro.graphio.formats import TileStore as JTileStore

    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    _, i = np.unique(src * nv + dst, return_index=True)
    src, dst = src[i], dst[i]
    val = (rng.uniform(0.1, 10.0, len(src)).astype(np.float32)
           if weighted else None)
    root = tempfile.mkdtemp(prefix=f"tcluster_store_{int(weighted)}_")
    spe.preprocess_arrays(src, dst, val, nv, JTileStore(root), tile_size)
    return root


@pytest.fixture(scope="module")
def stores():
    """(unweighted root, weighted root) shared by every test here."""
    return _make_store(False), _make_store(True)


def _progs(pkg, weighted):
    if weighted:
        return {"sssp": pkg.SSSP(source=0),
                "landmarks": pkg.LandmarkDistances(landmarks=(0, 9, 33))}
    return {"pagerank": pkg.PageRank(), "wcc": pkg.WCC(),
            "ppr": pkg.PersonalizedPageRank(seeds=(1, 7, 50)),
            "msbfs": pkg.MultiSourceBFS(sources=(2, 11, 60))}


def _single(root, prog, n, **kw):
    eng = OutOfCoreEngine(TileStore(root), EngineConfig(
        device="cpu", num_servers=n, max_supersteps=SS, **kw))
    return eng.run(prog)


def _reference(root, app, weighted, n, **kw):
    from repro.core import apps as japps
    from repro.core.engine import EngineConfig as JConfig
    from repro.core.engine import OutOfCoreEngine as JEngine
    from repro.graphio.formats import TileStore as JTileStore

    return JEngine(JTileStore(root), JConfig(
        num_servers=n, max_supersteps=SS, **kw)).run(
            _progs(japps, weighted)[app])


def _assert_same_run(got, want):
    assert np.array_equal(got.values, want.values)
    assert got.supersteps == want.supersteps
    assert got.converged == want.converged
    if want.per_query_supersteps is not None:
        assert np.array_equal(got.per_query_supersteps,
                              want.per_query_supersteps)


def _assert_ranks_agree(outs):
    """Every rank derived the same merged accounting and barrier events."""
    for hs in zip(*(o.history for o in outs)):
        for h in hs[1:]:
            assert h.wire_bytes == hs[0].wire_bytes
            assert h.updated_vertices == hs[0].updated_vertices
            assert (h.retired_queries, h.admitted_queries,
                    h.drained_queries) == (hs[0].retired_queries,
                                           hs[0].admitted_queries,
                                           hs[0].drained_queries)


def _thread_cluster(root, make_run, n, **cfg_kw):
    """Run on an in-process n-rank cluster (threads + shm rings):
    ``make_run(engine, rank)`` returns the rank's RunResult."""
    run_dir = tempfile.mkdtemp(prefix="tcluster_rings_")
    T.create_ring_files(run_dir, n)
    outs = [None] * n
    errs = [None] * n

    def worker(r):
        try:
            store = TileStore(root)
            store.load_meta()
            eng = OutOfCoreEngine(store, EngineConfig(
                device="cpu", num_servers=n, server_rank=r,
                max_supersteps=SS, **cfg_kw))
            tr = T.RingTransport(r, n, run_dir)
            ex = ClusterExchange(tr, assignment=eng.assignment,
                                 edges_per_tile=eng.plan.edges_per_tile,
                                 timeout=60.0)
            eng.exchange = ex
            try:
                outs[r] = make_run(eng, r)
            finally:
                ex.close()
                tr.close()
        except BaseException as exc:   # surfaced below
            errs[r] = exc

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    assert not any(t.is_alive() for t in threads)
    for r, e in enumerate(errs):
        assert e is None, f"rank {r}: {e!r}"
    return outs


def _run_app(app, weighted=False):
    return lambda eng, r: eng.run(_progs(tapps, weighted)[app])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("app", ["pagerank", "wcc", "msbfs"])
def test_inprocess_cluster_bit_identical(stores, app, n):
    root = stores[0]
    want = _single(root, _progs(tapps, False)[app], n)
    outs = _thread_cluster(root, _run_app(app), n)
    for out in outs:
        _assert_same_run(out, want)
    _assert_ranks_agree(outs)
    ref = _reference(root, app, False, n).values
    if app in EXACT_APPS:
        assert np.array_equal(outs[0].values, ref)
    else:
        np.testing.assert_allclose(outs[0].values, ref, **SUM_TOL)


@pytest.mark.parametrize("app", ["sssp", "landmarks"])
def test_inprocess_cluster_weighted(stores, app):
    root = stores[1]
    outs = _thread_cluster(root, _run_app(app, True), 2)
    for out in outs:
        _assert_same_run(out, _single(root, _progs(tapps, True)[app], 2))
    assert np.array_equal(outs[0].values,
                          _reference(root, app, True, 2).values)


def test_inprocess_cluster_multi_query_retirement(stores):
    root = stores[0]
    want = _single(root, _progs(tapps, False)["ppr"], 2)
    outs = _thread_cluster(root, _run_app("ppr"), 2)
    for out in outs:
        _assert_same_run(out, want)
        # column retirement is cluster-wide: same columns, same supersteps
        assert [h.retired_queries for h in out.history] == \
               [h.retired_queries for h in want.history]
    _assert_ranks_agree(outs)
    np.testing.assert_allclose(
        outs[0].values, _reference(root, "ppr", False, 2).values, **SUM_TOL)


@pytest.mark.parametrize("app", ["pagerank", "msbfs"])
def test_inprocess_cluster_ooc_vstate(stores, app):
    root = stores[0]
    kw = dict(vertex_memory_budget=2000, num_intervals=4)
    want = _single(root, _progs(tapps, False)[app], 2, **kw)
    outs = _thread_cluster(root, _run_app(app), 2, **kw)
    for out in outs:
        _assert_same_run(out, want)
        assert [h.vstate_dirty_intervals for h in out.history] == \
               [h.vstate_dirty_intervals for h in want.history]
    _assert_ranks_agree(outs)
    assert np.array_equal(want.values,
                          _single(root, _progs(tapps, False)[app], 2).values)


@pytest.mark.parametrize("mode", [dict(pipeline=True),
                                  dict(engine_mode="stacked"),
                                  dict(engine_mode="merged")],
                         ids=["pipelined", "stacked", "merged"])
def test_inprocess_cluster_engine_modes(stores, mode):
    root = stores[0]
    want = _single(root, tapps.PageRank(), 2)
    outs = _thread_cluster(root, _run_app("pagerank"), 2, **mode)
    for out in outs:
        _assert_same_run(out, want)


def test_exchange_steal_rebalances_deterministically(stores):
    """Both ranks derive the same post-steal assignment from the same
    replicated timings, and the merged updates are the same on both."""
    store = TileStore(stores[0])
    store.load_meta()
    eng = OutOfCoreEngine(store, EngineConfig(device="cpu", num_servers=2))
    run_dir = tempfile.mkdtemp(prefix="steal_rings_")
    T.create_ring_files(run_dir, 2)
    nv = eng.plan.num_vertices
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(nv, size=40, replace=False)).astype(np.int64)
    vals = rng.normal(size=40).astype(np.float32)
    results = [None, None]

    def worker(r):
        tr = T.RingTransport(r, 2, run_dir)
        ex = ClusterExchange(tr, assignment=eng.assignment,
                             edges_per_tile=eng.plan.edges_per_tile,
                             steal=True, straggler_factor=1.5, timeout=60.0)
        try:
            out = ex.exchange(idx=idx[r::2], vals=vals[r::2], mask=None,
                              nv=nv, compute_seconds=10.0 if r == 0 else 1.0)
            results[r] = (out, [list(a) for a in ex.assignment],
                          dict(ex.seconds))
        finally:
            ex.close()
            tr.close()

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120.0)
    (out0, asg0, sec0), (out1, asg1, _) = results
    assert np.array_equal(out0.idx, out1.idx)
    assert np.array_equal(out0.vals, out1.vals)
    assert np.array_equal(np.sort(out0.idx), idx)
    # rank 0 straggled 10x -> it sheds tiles; both agree on the result
    assert out0.assignment is not None
    assert asg0 == asg1
    assert len(asg0[0]) < len(eng.assignment[0])
    assert sorted(t for a in asg0 for t in a) == \
           sorted(t for a in eng.assignment for t in a)
    # every phase of the exchange was timed
    assert set(sec0) == {"exchange_encode", "exchange_send",
                         "exchange_wait", "exchange_decode",
                         "exchange_merge"}
    assert sec0["exchange_encode"] > 0 and sec0["exchange_decode"] > 0


def test_exchange_control_record_from_rank_0_only(stores):
    ex = ClusterExchange(types.SimpleNamespace(rank=1, n=1))
    with pytest.raises(ValueError, match="rank 0"):
        ex.exchange(idx=np.zeros(0, np.int64), vals=np.zeros(0, np.float32),
                    mask=None, nv=4, control={"admit": [[1, 2]]})


@pytest.mark.parametrize("how", ["constructor", "attribute"])
def test_exchange_needs_one_executed_server(stores, how):
    """An engine that emulates two servers would ship only the first's
    updates through an exchange: both ways of attaching one refuse it."""
    store = TileStore(stores[0])
    store.load_meta()
    cfg = EngineConfig(device="cpu", num_servers=2)
    ex = ClusterExchange(types.SimpleNamespace(rank=0, n=1))
    with pytest.raises(ValueError, match="exactly one executed server"):
        if how == "constructor":
            OutOfCoreEngine(store, cfg, exchange=ex)
        else:
            OutOfCoreEngine(store, cfg).exchange = ex


def test_cluster_admission_n2(stores):
    """Rank 0 ships the admit_plan record in its frame header; both ranks
    splice identically and match the fresh single-query run."""
    root = stores[0]
    fresh = _single(root, tapps.MultiSourceBFS(sources=(77,)), 2)
    prog = tapps.MultiSourceBFS(sources=(2, 11))
    kw = dict(admit_plan=((1, (77,)),))
    want = _single(root, prog, 2, **kw)
    outs = _thread_cluster(root, lambda eng, r: eng.run(prog), 2, **kw)
    for out in outs:
        _assert_same_run(out, want)
        assert np.array_equal(out.values[:, 2], fresh.values[:, 0])
        assert out.per_query_supersteps[2] == fresh.per_query_supersteps[0]
        assert out.history[1].admitted_queries == (2,)
    _assert_ranks_agree(outs)


def _admission_session(eng, rank):
    """A session at a full slot cap: rank 0 (or the single process)
    queues seed 77 and drains query 1 before superstep 0; the queued seed
    waits for a slot."""
    sess = eng.open_session(tapps.MultiSourceBFS(sources=(2, 11, 60)),
                            q_slots=3)
    if eng.exchange is None or eng.exchange.rank == 0:
        assert sess.admit([77]) == [3]
        sess.drain([1])
    elif eng.exchange is not None:
        with pytest.raises(RuntimeError, match="rank 0"):
            sess.admit([5])
    try:
        while not sess.finished:
            sess.step()
        return sess.result()
    finally:
        sess.close()


def test_cluster_queued_admission_refills_at_the_same_barrier(stores):
    """A queued admit() fills the slot a drain or a retirement frees at
    the barrier where it is freed, on every rank, as in one process."""
    root = stores[0]
    eng = OutOfCoreEngine(TileStore(root), EngineConfig(
        device="cpu", num_servers=2, max_supersteps=SS))
    want = _admission_session(eng, 0)
    assert want.history[0].drained_queries == (1,)
    assert want.history[0].admitted_queries == (3,)
    outs = _thread_cluster(root, _admission_session, 2)
    for out in outs:
        _assert_same_run(out, want)
        assert [h.admitted_queries for h in out.history] == \
               [h.admitted_queries for h in want.history]
    _assert_ranks_agree(outs)


# ---------------------------------------------------------------------------
# Real spawned clusters (launch.cluster)
# ---------------------------------------------------------------------------

class FailOnRank1(tapps.PageRank):
    """PageRank whose init raises in the spawned server of rank 1."""

    def init(self, *args, **kw):
        if mp.current_process().name == "graphh-server-1":
            raise RuntimeError("injected failure on rank 1")
        return super().init(*args, **kw)


def _assert_no_live_children(pids, grace=10.0):
    deadline = time.monotonic() + grace
    for pid in pids:
        while True:
            try:
                os.kill(pid, 0)
            except (ProcessLookupError, PermissionError):
                break
            assert time.monotonic() < deadline, f"child {pid} leaked"
            time.sleep(0.1)


@pytest.mark.parametrize("n", [2, 4])
def test_spawned_cluster_all_apps_bit_identical(stores, n):
    """All six apps in one launch over the weighted store (PageRank and
    PPR read its edge values), each equal on every rank to the
    single-process run on the same store."""
    root = stores[1]
    progs = {**_progs(tapps, False), **_progs(tapps, True)}
    out = run_cluster(root, list(progs.values()), ClusterConfig(
        num_servers=n, device="cpu",
        engine=EngineConfig(max_supersteps=SS)))
    assert out.verified
    assert len(out.rank_reports) == n and len(out.rank_results) == n
    for a, prog in enumerate(progs.values()):
        want = _single(root, prog, n)
        for r in range(n):
            _assert_same_run(out.rank_results[r][a], want)
        _assert_ranks_agree([out.rank_results[r][a] for r in range(n)])
    for rep in out.rank_reports:
        assert rep["device"] == "cpu"
        assert rep["launches"] == dict(segment_reduce=0, gab_fused=0,
                                       compact=0)   # the CPU runs no kernel
        assert rep["wire_bytes"] > 0
        assert len(rep["exchange_seconds"]) == len(progs)
        assert all(p["exchange_encode"] > 0 for p in rep["exchange_seconds"])


def test_spawned_cluster_tcp_and_steal(stores):
    root = stores[0]
    want = _single(root, tapps.PageRank(), 2)
    out = run_cluster(root, [tapps.PageRank(), tapps.BFS()], ClusterConfig(
        num_servers=2, transport="tcp", steal=True, device="cpu",
        engine=EngineConfig(max_supersteps=SS)))
    assert out.verified
    _assert_same_run(out.results[0], want)
    _assert_same_run(out.results[1], _single(root, tapps.BFS(), 2))
    asg = out.rank_reports[0]["final_assignment"]
    assert asg == out.rank_reports[1]["final_assignment"]
    assert sorted(t for a in asg for t in a) == list(
        range(TileStore(root).load_plan().num_tiles))


def test_spawned_cluster_rank_failure_names_the_rank(stores):
    t0 = time.monotonic()
    with pytest.raises(ClusterFailure, match="server 1 failed") as ei:
        run_cluster(stores[0], [FailOnRank1()], ClusterConfig(
            num_servers=2, device="cpu", timeout_seconds=60,
            launch_timeout_seconds=120,
            engine=EngineConfig(max_supersteps=SS)))
    assert time.monotonic() - t0 < 60       # fail fast, not a timeout
    assert ei.value.dead_ranks == [1]
    assert "injected failure on rank 1" in str(ei.value)
    assert len(ei.value.pids) == 2
    _assert_no_live_children(ei.value.pids)


@pytest.mark.parametrize("knobs", [
    dict(on_failure="restart"), dict(on_failure="shrink"),
    dict(max_restarts=5),
    dict(engine=EngineConfig(checkpoint_dir="ckpt"))])
def test_later_cluster_knobs_raise(stores, knobs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A.10"):
        run_cluster(stores[0], [tapps.PageRank()],
                    ClusterConfig(device="cpu", **knobs))


def test_cuda_cluster_without_a_card_raises(stores):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ClusterConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_cluster(stores[0], [tapps.PageRank()], ClusterConfig())


def test_cli_cluster_runs_on_cpu(stores, tmp_path, capsys):
    out = tgraph.main(["--cluster", "--servers", "2", "--device", "cpu",
                       "--app", "msbfs", "--queries", "3", "--admit",
                       "1:17", "--vertices", "2000", "--edges", "20000",
                       "--tile-size", "1024", "--verify-clean",
                       "--store", str(tmp_path / "s")])
    assert out.verified
    text = capsys.readouterr().out
    assert "msbfs x2 servers [shm, cpu]" in text
    assert "verify-clean: byte-identical" in text


@pytest.mark.parametrize("argv", [["--cluster", "--checkpoint-dir", "x"],
                                  ["--cluster", "--resume"]])
def test_cli_cluster_rejects_later_flags(argv):
    from repro_torch.launch import cluster as tcluster

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A.10"):
        tcluster.main(argv[1:])


def test_cli_takes_cluster_flags():
    args = tgraph.parse_args(["--cluster", "--transport", "tcp", "--steal",
                              "--verify-clean"])
    assert (args.cluster, args.transport, args.steal,
            args.verify_clean) == (True, "tcp", True, True)
    argv = tgraph._cluster_argv(args)
    assert "--steal" in argv and "--verify-clean" in argv
    assert argv[argv.index("--transport") + 1] == "tcp"


# ---------------------------------------------------------------------------
# Scheduler units backing the cluster runtime
# ---------------------------------------------------------------------------

def test_rebalance_assignment_noop_when_balanced():
    asg = [[0, 2], [1, 3]]
    edges = np.array([10, 10, 10, 10])
    assert rebalance_assignment(asg, edges, [1.0, 1.1]) is None
    assert rebalance_assignment([[0], [1]], edges[:2], [0.0, 0.0]) is None


def test_rebalance_assignment_moves_off_straggler():
    from repro.runtime.scheduler import rebalance_assignment as jrebalance

    asg = [[0, 1, 2, 3], [4, 5, 6, 7]]
    edges = np.array([100, 90, 80, 70, 10, 10, 10, 10])
    out = rebalance_assignment(asg, edges, [10.0, 1.0])
    assert out is not None
    new, moved = out
    assert moved > 0
    assert len(new[0]) < 4
    assert sorted(t for a in new for t in a) == list(range(8))
    assert rebalance_assignment(asg, edges, [10.0, 1.0]) == out
    assert jrebalance(asg, edges, [10.0, 1.0]) == out
