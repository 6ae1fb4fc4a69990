"""The port's engine slice against the JAX package's, on the same stores.

Both engines read one tile store written by ``repro.graphio.spe``.  The
port runs on ``device="cpu"`` (the kernels' plain versions) over the grid
of servers, tile-skip filters and ``seg_impl``; the reference runs once
per app through its ``jnp`` path (results there are invariant across
servers and filters), plus ``pallas_fused`` (interpret mode) for one app
per monoid.

Tolerances: SSSP, WCC, BFS and InDegree are ``array_equal`` (min, max and
small-integer sums are exact).  PageRank is held to ``rtol=1e-5,
atol=1e-6`` after a fixed number of supersteps: the port sums each row in
another order than XLA, and XLA may contract the apply into an FMA
(gab_fused.py:25-40), so the last bits may differ.
"""
import numpy as np
import pytest
import torch

from repro.core import apps as japps
from repro.core import comm as jcomm
from repro.core import gab as jgab
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import OutOfCoreEngine as JEngine
from repro.core.tiles import tile_edge_values
from repro.graphio import spe as jspe
from repro.graphio.formats import TileStore as JTileStore
from repro_torch.core import apps as tapps
from repro_torch.core import comm as tcomm
from repro_torch.core import gab as tgab
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio.formats import TileStore
from repro_torch.launch import graph as tgraph
from repro_torch.runtime.faults import FaultPlan

PR_TOL = dict(rtol=1e-5, atol=1e-6)
PR_SUPERSTEPS = 15
APPS = ("pagerank", "sssp", "wcc", "bfs", "indegree")


def _prog(pkg, app):
    return {"pagerank": pkg.PageRank, "sssp": pkg.SSSP, "wcc": pkg.WCC,
            "bfs": pkg.BFS, "indegree": pkg.InDegree}[app]()


@pytest.fixture(scope="module")
def weighted_store(small_graph, tmp_path_factory):
    nv, src, dst = small_graph
    val = np.random.default_rng(3).uniform(0.5, 2.0, len(src)).astype(
        np.float32)
    store = JTileStore(str(tmp_path_factory.mktemp("wstore")))
    jspe.preprocess_arrays(src, dst, val, nv, store, tile_size=100)
    return store


def _store_for(app, small_store, weighted_store):
    return weighted_store if app == "sssp" else small_store[0]


def _max_ss(app):
    return PR_SUPERSTEPS if app == "pagerank" else 200


@pytest.fixture(scope="module")
def reference(small_store, weighted_store):
    """{(app, jax seg_impl): final values} from the JAX engine."""
    out = {}
    for app, impl in [(a, "jnp") for a in APPS] + [("pagerank", "pallas_fused"),
                                                   ("sssp", "pallas_fused")]:
        store = _store_for(app, small_store, weighted_store)
        eng = JEngine(store, JConfig(num_servers=1, seg_impl=impl,
                                     max_supersteps=_max_ss(app)))
        out[app, impl] = eng.run(_prog(japps, app)).values
    return out


def _port_run(store_root, app, **kw):
    cfg = EngineConfig(device="cpu", max_supersteps=_max_ss(app), **kw)
    return OutOfCoreEngine(TileStore(store_root), cfg).run(_prog(tapps, app))


def _assert_app_match(app, got, want):
    if app == "pagerank":
        np.testing.assert_allclose(got, want, **PR_TOL)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("servers", [1, 2])
@pytest.mark.parametrize("skip", ["bitmap", "bloom", "off"])
@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
def test_engine_matches_reference(app, servers, skip, seg_impl, reference,
                                  small_store, weighted_store):
    store = _store_for(app, small_store, weighted_store)
    res = _port_run(store.root, app, num_servers=servers,
                    tile_skipping=skip != "off",
                    skip_filter="bitmap" if skip == "off" else skip,
                    seg_impl=seg_impl)
    assert res.values.dtype == np.float32
    if app != "pagerank":
        assert res.converged
    _assert_app_match(app, res.values, reference[app, "jnp"])
    if (app, "pallas_fused") in reference:
        _assert_app_match(app, res.values, reference[app, "pallas_fused"])


@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
def test_pagerank_matches_networkx(seg_impl, small_store, nx_pagerank):
    store, _, _ = small_store
    cfg = EngineConfig(device="cpu", num_servers=3, seg_impl=seg_impl)
    res = OutOfCoreEngine(TileStore(store.root), cfg).run(
        tapps.PageRank(update_tol=1e-10))
    assert res.converged
    ours = res.values / res.values.sum()
    assert np.abs(ours - nx_pagerank).max() < 1e-7


def test_indegree_counts(small_store):
    store, _, (nv, _, dst) = small_store
    res = _port_run(store.root, "indegree")
    assert np.array_equal(res.values, np.bincount(dst, minlength=nv))
    assert res.history[0].tiles_processed == len(
        TileStore(store.root).load_plan().edges_per_tile)


_STAT_FIELDS = ("updated_vertices", "tiles_processed", "tiles_skipped",
                "raw_bytes", "wire_bytes", "network_bytes", "cache_hit_ratio",
                "disk_bytes_read")


@pytest.mark.parametrize("cache_mode", [1, 2, 3, 4])
@pytest.mark.parametrize("comm_mode", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("skip_filter", ["bitmap", "bloom"])
def test_superstep_stats_match_reference(cache_mode, comm_mode, skip_filter,
                                         small_store):
    """BFS's measured supersteps equal the reference's, field by field: an
    edge cache that holds under half the raw store (mode 1 evicts and
    rereads), the LPT tile assignment, fine skip-filter blocks (tiles are
    skipped) and each broadcast mode, whose payloads compress alike."""
    store, _, _ = small_store
    kw = dict(num_servers=2, cache_mode=cache_mode, comm_mode=comm_mode,
              cache_capacity_bytes=6_000, balanced_assignment=True,
              skip_filter=skip_filter, block_shift=2)
    want = JEngine(JTileStore(store.root), JConfig(seg_impl="jnp", **kw)).run(
        japps.BFS())
    got = OutOfCoreEngine(TileStore(store.root),
                          EngineConfig(device="cpu", **kw)).run(tapps.BFS())
    assert np.array_equal(got.values, want.values)
    assert got.supersteps == want.supersteps
    for g, w in zip(got.history, want.history):
        assert [getattr(g, f) for f in _STAT_FIELDS] == \
            [getattr(w, f) for f in _STAT_FIELDS]


@pytest.mark.parametrize("app", ["pagerank", "sssp", "bfs"])
@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
def test_tile_step_matches_reference(app, seg_impl, weighted_store):
    """Per-tile (rows, new, updated) of the port's run_tile against the
    reference's, on a weighted store, from the same initial state."""
    store = TileStore(weighted_store.root)
    plan = store.load_plan()
    in_deg, out_deg = store.load_degrees()
    jprog, tprog = _prog(japps, app), _prog(tapps, app)
    state = jprog.init(plan.num_vertices, out_deg.astype(np.float64),
                       in_deg.astype(np.float64))
    rng = np.random.default_rng(1)
    # a mid-run state: finite, distinct values on every vertex
    state["value"] = rng.uniform(0.0, 3.0, plan.num_vertices).astype(
        np.float32)
    tstate = tgab.state_from_numpy(state, "cpu")
    values = tstate.pop("value")
    jvalues = state.pop("value")
    jimpl = "pallas_fused" if seg_impl == "fused" else "jnp"
    for t in range(plan.num_tiles):
        tile = store.read_tile(t)
        arrays = (tile.src, tile.dst_local, tile_edge_values(tile))
        got = tgab.run_tile(tprog, values, tstate, arrays, tile.meta.row_start,
                            tile.meta.num_rows, plan.row_cap, seg_impl)
        want = jgab.run_tile(jprog, jvalues, state, arrays,
                             tile.meta.row_start, tile.meta.num_rows,
                             plan.row_cap, jimpl)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        _assert_app_match(app, got[1].numpy(), np.asarray(want[1]))
        if app != "pagerank":
            assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("mode", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_broadcast_measurement_matches_reference(mode, density):
    rng = np.random.default_rng(int(density * 100))
    nv = 5000
    values = rng.normal(size=nv).astype(np.float32)
    updated = rng.random(nv) < density
    got = tcomm.plan_broadcast(values, updated, mode=mode)
    want = jcomm.plan_broadcast(values, updated, mode=mode)
    assert vars(got) == vars(want)
    for name in ("dense_payload", "sparse_payload"):
        assert getattr(tcomm, name)(values, updated) == \
            getattr(jcomm, name)(values, updated)
    idx, vals = tcomm.decode_dense_payload(
        tcomm.dense_payload(values, updated), nv, np.float32)
    assert np.array_equal(idx, np.nonzero(updated)[0])
    assert np.array_equal(vals, values[updated])
    idx, vals = tcomm.decode_sparse_payload(
        tcomm.sparse_payload(values, updated), np.float32)
    assert np.array_equal(idx, np.nonzero(updated)[0])
    assert tcomm.wire_bytes_estimate(nv, density) == \
        jcomm.wire_bytes_estimate(nv, density)
    rec = tcomm.pack_admissions([(3, 17)], [2], 1)
    assert rec == jcomm.pack_admissions([(3, 17)], [2], 1)
    assert tcomm.unpack_admissions(rec) == jcomm.unpack_admissions(rec)


@pytest.mark.parametrize("knob", [
    dict(kernel_autotune=True), dict(kernel_blocks=(512, 256)),
    dict(kernel_autotune=True, checkpoint_dir="ckpt"),
    dict(kernel_blocks=(512, 256), resume=True),
    dict(kernel_autotune=True, preemptible=True),
    dict(kernel_blocks=(512, 256), fault_plan=FaultPlan()),
    dict(kernel_autotune=True, server_rank=0, checkpoint_dir="ckpt")])
def test_knobs_outside_the_slice_raise(knob, small_store, tmp_path):
    """The tuner's knobs (queue A.12, once refused here) are live, also
    beside the checkpoint and fault knobs: the engine takes them,
    ``kernel_plan`` returns the tuner's pick (blocks and stack size) or
    the blocks verbatim, and a run equals the default blocks' bit for
    bit."""
    from repro_torch.roofline import kernel_tune

    store, _, _ = small_store
    knob = {k: str(tmp_path / v) if k == "checkpoint_dir" else v
            for k, v in knob.items()}
    cfg = EngineConfig(device="cpu", **knob)
    assert cfg.unsupported() == []
    eng = OutOfCoreEngine(TileStore(store.root), cfg)
    prog = tapps.PageRank()
    impl, blocks, stack = eng.kernel_plan(prog)
    assert impl == "fused"
    if "kernel_blocks" in knob:
        assert (blocks, stack) == ((512, 256), cfg.stack_size)
        assert eng.kernel_choice is None
    else:
        pick = kernel_tune.pick_blocks("sum", 1, eng.plan.edge_cap,
                                       eng.plan.row_cap)
        assert (blocks, stack) == (pick.blocks, pick.stack_size)
        assert eng.kernel_choice == pick
    if cfg.server_rank is None:
        got = eng.run(prog, max_supersteps=3)
        want = OutOfCoreEngine(TileStore(store.root), EngineConfig(
            device="cpu")).run(tapps.PageRank(), max_supersteps=3)
        assert np.array_equal(got.values, want.values)


def test_batched_program_raises(small_store):
    """Admission needs a batched program and a live session: a
    single-query session and a finished one refuse ``admit()``."""
    store, _, _ = small_store
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(device="cpu"))
    with pytest.raises(RuntimeError, match="batched"):
        eng.open_session(tapps.BFS()).admit([2])
    sess = eng.open_session(tapps.MultiSourceBFS(sources=(0, 5)),
                            max_supersteps=1)
    sess.step()
    with pytest.raises(RuntimeError, match="finished"):
        sess.admit([2])


def test_session_opens_with_q_slots(small_store):
    store, _, _ = small_store
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(device="cpu"))
    sess = eng.open_session(tapps.MultiSourceBFS(sources=(0, 5)), q_slots=4)
    assert sess.q_slots == 4 and sess.free_slots == 2
    assert sess.admit([17]) == [2]
    sess.step()
    assert sess.active_queries == (0, 1, 2)


def test_admit_plan_runs(small_store):
    store, _, _ = small_store
    res = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        device="cpu", admit_plan=((1, (17,)),))).run(
            tapps.MultiSourceBFS(sources=(0, 5)))
    fresh = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        device="cpu")).run(tapps.MultiSourceBFS(sources=(17,)))
    assert res.history[1].admitted_queries == (2,)
    assert np.array_equal(res.values[:, 2], fresh.values[:, 0])


def test_seg_impl_names(small_store):
    store, _, _ = small_store
    with pytest.raises(ValueError, match="no counterpart"):
        OutOfCoreEngine(TileStore(store.root),
                        EngineConfig(device="cpu", seg_impl="jnp"))


def test_cuda_device_without_a_card_raises(small_store):
    """The default device is the card; with none, the engine raises
    instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    store, _, _ = small_store
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        OutOfCoreEngine(TileStore(store.root), EngineConfig())


def test_cli_runs_on_cpu(tmp_path, capsys):
    res = tgraph.main(["--app", "bfs", "--vertices", "2000", "--edges",
                       "20000", "--tile-size", "4096", "--servers", "2",
                       "--store", str(tmp_path / "s"), "--device", "cpu"])
    assert res.converged
    assert "bfs:" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--kernel-autotune"],
                                  ["--serve-http", "--kernel-autotune"],
                                  ["--kernel-autotune", "--checkpoint-dir",
                                   "x"], ["--serve", "--kernel-autotune"]])
def test_cli_rejects_flags_outside_the_slice(argv):
    """``--kernel-autotune`` (queue A.12, once refused) parses in every
    mode, and no reference flag is left outside the port."""
    args = tgraph.parse_args(argv)
    assert args.kernel_autotune
    assert tgraph._LATER_FLAGS == {}


@pytest.mark.parametrize("argv", [["--vertex-memory-budget", "10"],
                                  ["--admit", "1:17,42"]])
def test_cli_takes_flags_of_this_slice(argv):
    args = tgraph.parse_args(argv)
    assert (args.vertex_memory_budget, args.admit) in ((10.0, None),
                                                       (None, ["1:17,42"]))
