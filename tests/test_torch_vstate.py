"""The port's out-of-core vertex state against the JAX package's.

``repro_torch.core.vstate`` is a copy of ``repro.core.vstate``: the same
operations on the same arrays give the same blocks, tiers and counters
(timings aside).  The per-dirty-interval broadcast records are equal to
the reference's.  The engine under ``vertex_memory_budget`` — serial and
pipelined, down to a 10 % budget — is bit-identical to the port's
in-memory tiled run, and matches the reference's out-of-core run by the
port's rules: min/max apps and InDegree ``array_equal`` with every
``vstate_*`` counter equal superstep by superstep (the store sees the
same accesses in the same order and compresses the same bytes);
PageRank and PPR within ``rtol=1e-5, atol=1e-6`` (another order of
summation; their compressed block sizes then differ too).  The port runs
on ``device="cpu"`` (the kernels' plain versions), the reference under
``JAX_PLATFORMS=cpu``.
"""
import os

import numpy as np
import pytest

from repro.core import apps as japps
from repro.core import comm as jcomm
from repro.core import gab as jgab
from repro.core import vstate as jvstate
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import OutOfCoreEngine as JEngine
from repro.graphio import spe as jspe
from repro.graphio.formats import TileStore as JTileStore
from repro_torch.core import apps as tapps
from repro_torch.core import comm as tcomm
from repro_torch.core import gab as tgab
from repro_torch.core import vstate as tvstate
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.core.tiles import tile_edge_values
from repro_torch.graphio.formats import TileStore
from repro_torch.launch import graph as tgraph

PR_TOL = dict(rtol=1e-5, atol=1e-6)
SPLIT = np.array([0, 40, 90, 150, 200], dtype=np.int64)
# cold_faults is left out: the reference never counts it (ROADMAP queue C)
STAT_KEYS = ("hits", "faults", "warm_faults", "load_bytes", "spills",
             "spill_bytes", "dirty_writebacks")
VSTATE_FIELDS = ("vstate_faults", "vstate_load_bytes", "vstate_spill_bytes",
                 "vstate_dirty_intervals")
EXACT_STAT_FIELDS = VSTATE_FIELDS + ("updated_vertices", "updated_pairs",
                                     "raw_bytes", "wire_bytes",
                                     "tiles_processed", "retired_queries")
SERVERS = 3


# --------------------------- VertexStateStore ------------------------------

def _stores(tmp_path, budget):
    return (tvstate.VertexStateStore(SPLIT, budget, str(tmp_path / "t")),
            jvstate.VertexStateStore(SPLIT, budget, str(tmp_path / "j")))


def _same_state(t, j):
    ts, js = t.stats.as_dict(), j.stats.as_dict()
    assert [ts[k] for k in STAT_KEYS] == [js[k] for k in STAT_KEYS]
    assert ts["cold_faults"] == ts["faults"] - ts["warm_faults"]
    assert t.tier_snapshot() == j.tier_snapshot()
    assert t.hot_intervals() == j.hot_intervals()
    assert t.resident_bytes() == j.resident_bytes()
    assert t.names() == j.names()
    for name in t.names():
        assert t.spec(name) == j.spec(name)
        for k in range(t.num_intervals):
            assert t.block_version(name, k) == j.block_version(name, k)
            assert t.export_block(name, k) == j.export_block(name, k)


@pytest.mark.parametrize("dtype,tail", [
    (np.float32, ()), (np.float64, ()), (np.int64, ()),
    (np.float32, (5,)), (np.float64, (3,)),
], ids=["f32", "f64", "i64", "f32_q5", "f64_q3"])
@pytest.mark.parametrize("budget", [1, 2_000, None],
                         ids=["all_cold", "tight", "unlimited"])
def test_store_matches_reference(tmp_path, dtype, tail, budget):
    """Spill/reload round trip, reads under pressure, a dirty writeback
    and (for [V, Q] arrays) compact_columns then append_columns: the
    port's store ends in the reference's state, block for block."""
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((200,) + tail) * 1000).astype(dtype)
    t, j = _stores(tmp_path, budget)
    for vs in (t, j):
        vs.add_array("value", arr)
        vs.add_array("aux", arr[::-1].copy())
    _same_state(t, j)
    for _ in range(2):
        for k in range(t.num_intervals):
            for vs in (t, j):
                vs.get_block("value", k)
                vs.get_block("aux", (k + 1) % vs.num_intervals)
    _same_state(t, j)
    for vs in (t, j):
        blk = vs.get_block("value", 2).copy()
        blk += 1
        vs.write_block("value", 2, blk)
        vs.get_block("value", 0)
    _same_state(t, j)
    want = arr.copy()
    want[90:150] += 1
    if tail:
        keep = np.arange(tail[0]) % 2 == 0
        extra = (rng.standard_normal((200, 2)) * 10).astype(dtype)
        for vs in (t, j):
            vs.compact_columns(["value"], keep)
            vs.append_columns({"value": extra})
        _same_state(t, j)
        want = np.concatenate([want[:, keep], extra], axis=1)
    got = t.materialize("value")
    assert got.dtype == arr.dtype
    assert np.array_equal(got, want)
    assert np.array_equal(got, j.materialize("value"))
    t.close()
    j.close()
    assert not os.path.exists(str(tmp_path / "t"))


def test_dirty_writeback_only(tmp_path):
    """Clean blocks demote for free once serialized; only a written block
    pays a new disk write on its way back down — in both packages."""
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((200, 4)).astype(np.float32)
    t, j = _stores(tmp_path, 2 * arr[0:40].nbytes)
    for vs in (t, j):
        vs.add_array("value", arr)
        for k in range(vs.num_intervals):
            vs.get_block("value", k)
    spills0 = t.stats.spills
    for _ in range(3):
        for k in range(t.num_intervals):
            for vs in (t, j):
                vs.get_block("value", k)
    assert t.stats.spills == spills0 and t.stats.faults > 0
    for vs in (t, j):
        dirty = vs.get_block("value", 0).copy() + 1.0
        vs.write_block("value", 0, dirty)
        for k in range(vs.num_intervals):
            vs.get_block("value", k)
    assert t.stats.spills == spills0 + 1
    _same_state(t, j)
    assert np.array_equal(t.materialize("value")[:40], dirty)
    t.close()
    j.close()


def test_cold_faults_are_counted(tmp_path):
    """Every fault is warm or cold.  The reference never counts its cold
    faults (``repro/core/vstate.py:201-210``); the port does."""
    t, j = _stores(tmp_path, 1)
    for vs in (t, j):
        vs.add_array("value", np.arange(200, dtype=np.float32))
        vs.materialize("value")
    assert t.stats.faults == j.stats.faults == t.num_intervals
    assert t.stats.warm_faults == j.stats.warm_faults == 0
    assert t.stats.cold_faults == t.num_intervals
    assert j.stats.cold_faults == 0
    t.close()
    j.close()


def test_geometry_and_capacity(tmp_path):
    t, j = _stores(tmp_path, 3 * 50 * 4)
    for vs in (t, j):
        vs.add_array("value", np.arange(200, dtype=np.float32))
    ids = np.array([0, 39, 40, 199])
    assert np.array_equal(t.interval_of(ids), j.interval_of(ids))
    assert [t.interval_range(k) for k in range(4)] == \
        [j.interval_range(k) for k in range(4)]
    assert t.hot_block_capacity() == j.hot_block_capacity() == 2
    assert (tvstate.VertexStateStore(SPLIT).hot_block_capacity()
            == t.num_intervals)
    t.close()
    j.close()


def test_close_without_spill_dir_is_noop():
    vs = tvstate.VertexStateStore(SPLIT, budget_bytes=None, spill_dir=None)
    vs.add_array("value", np.arange(200, dtype=np.float32))
    vs.close()
    assert np.array_equal(vs.materialize("value"),
                          np.arange(200, dtype=np.float32))


# --------------------------- per-interval broadcast -------------------------

@pytest.mark.parametrize("case", ["sparse", "dense_interval", "multiquery",
                                  "empty"])
@pytest.mark.parametrize("compressor", ["none", "zstd-1"])
@pytest.mark.parametrize("mode", ["hybrid", "dense", "sparse"])
def test_interval_broadcast_matches_reference(case, compressor, mode):
    rng = np.random.default_rng(5)
    splitter = np.array([0, 100, 250, 300, 500], dtype=np.int64)
    mask = None
    if case == "sparse":
        idx = np.array([5, 7, 205, 499], dtype=np.int64)
        vals = rng.normal(size=4).astype(np.float32)
    elif case == "dense_interval":          # one interval over the switch
        idx = np.concatenate([np.arange(100, 230), [301]]).astype(np.int64)
        vals = rng.normal(size=len(idx)).astype(np.float32)
    elif case == "multiquery":
        idx = np.sort(rng.choice(500, 60, replace=False)).astype(np.int64)
        vals = rng.normal(size=(60, 3)).astype(np.float32)
        mask = rng.random((60, 3)) < 0.5
        mask[:, 0] = True
    else:
        idx = np.zeros(0, np.int64)
        vals = np.zeros((0, 2), np.float32)
        mask = np.zeros((0, 2), bool)
    kw = dict(compressor=compressor, mode=mode)
    got = tcomm.plan_broadcast_intervals(idx, vals, mask, splitter, **kw)
    want = jcomm.plan_broadcast_intervals(idx, vals, mask, splitter, **kw)
    assert vars(got) == vars(want)
    assert got.mode == "interval"
    fut = tcomm.plan_broadcast_intervals_async(idx, vals, mask, splitter,
                                               **kw)
    assert vars(fut.result(timeout=60)) == vars(got)
    assert tcomm.INTERVAL_HEADER_BYTES == jcomm.INTERVAL_HEADER_BYTES


# --------------------------- engine -----------------------------------------

@pytest.fixture(scope="module")
def weighted_store(small_graph, tmp_path_factory):
    nv, src, dst = small_graph
    val = np.random.default_rng(3).uniform(0.5, 2.0, len(src)).astype(
        np.float32)
    store = JTileStore(str(tmp_path_factory.mktemp("wstore")))
    jspe.preprocess_arrays(src, dst, val, nv, store, tile_size=100)
    return store


@pytest.fixture(scope="module")
def planned_store(small_graph, tmp_path_factory):
    """Weighted tiles written with a stored interval plan (K = 4): GHT2
    tiles carry their source footprints."""
    nv, src, dst = small_graph
    val = np.random.default_rng(3).uniform(0.5, 2.0, len(src)).astype(
        np.float32)
    store = JTileStore(str(tmp_path_factory.mktemp("planned")))
    jspe.preprocess_arrays(src, dst, val, nv, store, tile_size=100,
                           num_intervals=4)
    return store


APPS = {
    "pagerank": (lambda p: p.PageRank(update_tol=1e-10), False),
    "msbfs": (lambda p: p.MultiSourceBFS(sources=(0, 5, 17, 200)), False),
    "ppr": (lambda p: p.PersonalizedPageRank(seeds=(0, 5, 17)), False),
    "indegree": (lambda p: p.InDegree(), False),
    "wcc": (lambda p: p.WCC(), False),
    "sssp": (lambda p: p.SSSP(source=0), True),
    "landmarks": (lambda p: p.LandmarkDistances(landmarks=(0, 9, 33)),
                  True),
}
SUMS = ("pagerank", "ppr")


def _root(app, small_store, weighted_store):
    return (weighted_store if APPS[app][1] else small_store[0]).root


def _budget(prog, nv, share):
    """``share`` of the whole vertex footprint (value + aux arrays)."""
    state = prog.init(nv, np.ones(nv), np.ones(nv))
    return max(1, int(sum(np.asarray(a).nbytes for a in state.values())
                      * share))


def _port(root, prog, **kw):
    cfg = EngineConfig(device="cpu", num_servers=SERVERS, **kw)
    return OutOfCoreEngine(TileStore(root), cfg).run(prog)


def _ref(root, prog, **kw):
    cfg = JConfig(seg_impl="jnp", num_servers=SERVERS, **kw)
    return JEngine(JTileStore(root), cfg).run(prog)


def _fields(res, fields):
    return [[getattr(h, f) for f in fields] for h in res.history]


def _assert_match(app, got, want):
    if app in SUMS:
        np.testing.assert_allclose(got.values, want.values, **PR_TOL)
    else:
        assert np.array_equal(got.values, want.values)
        assert got.supersteps == want.supersteps
        if want.per_query_supersteps is not None:
            assert np.array_equal(got.per_query_supersteps,
                                  want.per_query_supersteps)
        assert _fields(got, EXACT_STAT_FIELDS) == \
            _fields(want, EXACT_STAT_FIELDS)


@pytest.fixture(scope="module")
def reference(small_store, weighted_store):
    """{app: the JAX engine's out-of-core run at a 25 % budget}."""
    nv = small_store[1].num_vertices
    out = {}
    for app, (mk, _) in APPS.items():
        root = _root(app, small_store, weighted_store)
        out[app] = _ref(root, mk(japps), max_supersteps=60,
                        vertex_memory_budget=_budget(mk(japps), nv, 0.25))
    return out


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("share", [0.25, 0.1])
def test_ooc_bit_identical_to_in_memory(app, pipeline, share, small_store,
                                        weighted_store, reference):
    root = _root(app, small_store, weighted_store)
    nv = small_store[1].num_vertices
    mk = APPS[app][0]
    mem = _port(root, mk(tapps), max_supersteps=60, pipeline=pipeline)
    res = _port(root, mk(tapps), max_supersteps=60, pipeline=pipeline,
                vertex_memory_budget=_budget(mk(tapps), nv, share))
    assert res.supersteps == mem.supersteps
    assert np.array_equal(res.values, mem.values)
    if mem.per_query_supersteps is not None:
        assert np.array_equal(res.per_query_supersteps,
                              mem.per_query_supersteps)
    assert res.aux.keys() == mem.aux.keys()
    for k in mem.aux:
        assert np.array_equal(res.aux[k], mem.aux[k])
    # the budget binds: state faulted back in and spilled to disk
    assert sum(h.vstate_faults for h in res.history) > 0
    assert sum(h.vstate_spill_bytes for h in res.history) > 0
    assert all(h.vstate_faults == 0 for h in mem.history)
    if share == 0.25:
        _assert_match(app, res, reference[app])


@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
@pytest.mark.parametrize("app", ["pagerank", "sssp", "msbfs"])
def test_sharded_tile_step(app, seg_impl, weighted_store):
    """run_tile_sharded on host-gathered inputs whose padding slots hold
    zeros equals run_tile (which gathers values[0] there) bit for bit on
    every tile, and the reference's run_tile_sharded by the port's
    rules."""
    store = TileStore(weighted_store.root)
    plan = store.load_plan()
    nv, rc = plan.num_vertices, plan.row_cap
    in_deg, out_deg = store.load_degrees()
    mk = APPS[app][0]
    state = mk(tapps).init(nv, out_deg.astype(np.float64),
                           in_deg.astype(np.float64))
    rng = np.random.default_rng(2)
    state["value"] = rng.uniform(0.0, 3.0, state["value"].shape).astype(
        np.float32)
    tstate = tgab.state_from_numpy(state, "cpu")
    values = tstate.pop("value")
    jimpl = "pallas_fused" if seg_impl == "fused" else "jnp"
    for t in range(plan.num_tiles):
        tile = store.read_tile(t)
        m = tile.meta
        ev = tile_edge_values(tile)
        real = np.arange(m.edge_cap) < m.num_edges
        src_vals = np.where(real[:, None] if state["value"].ndim == 2
                            else real, state["value"][tile.src], 0)
        src_aux = {k: np.where(real, state[k][tile.src], 0)
                   for k in mk(tapps).src_aux}
        old = np.zeros((rc,) + state["value"].shape[1:], np.float32)
        old[:m.num_rows] = state["value"][m.row_start:m.row_end]
        dst_aux = {}
        for k in mk(tapps).dst_aux:
            dst_aux[k] = np.zeros((rc,) + state[k].shape[1:], state[k].dtype)
            dst_aux[k][:m.num_rows] = state[k][m.row_start:m.row_end]
        args = (src_vals.astype(np.float32), src_aux, ev, tile.dst_local,
                old, dst_aux, m.num_rows, rc)
        new, upd = tgab.run_tile_sharded(mk(tapps), *args, seg_impl,
                                         device="cpu")
        _, mem_new, mem_upd = tgab.run_tile(
            mk(tapps), values, tstate, (tile.src, tile.dst_local, ev),
            m.row_start, m.num_rows, rc, seg_impl)
        # rows past num_rows keep old (zeros here, values[rows] there)
        # and are never updated
        nr = m.num_rows
        assert np.array_equal(new.numpy()[:nr], mem_new.numpy()[:nr])
        assert np.array_equal(upd.numpy(), mem_upd.numpy())
        assert not upd.numpy()[nr:].any()
        if t % 4:
            continue      # the reference (Pallas interpreted) on every 4th
        jnew, jupd = jgab.run_tile_sharded(mk(japps), *args, jimpl)
        if app == "pagerank":
            np.testing.assert_allclose(new.numpy(), np.asarray(jnew),
                                       **PR_TOL)
        else:
            assert np.array_equal(new.numpy(), np.asarray(jnew))
            assert np.array_equal(upd.numpy(), np.asarray(jupd))


@pytest.mark.parametrize("mode", ["stacked", "merged"])
def test_ooc_forces_tiled(mode, small_store):
    """stacked/merged need the whole value array on the device, so the
    out-of-core run is tiled — and equals the in-memory run of the
    requested mode bit for bit."""
    root = small_store[0].root
    nv = small_store[1].num_vertices
    prog = tapps.MultiSourceBFS(sources=(0, 5, 17, 200))
    mem = _port(root, prog, engine_mode=mode)
    res = _port(root, prog, engine_mode=mode,
                vertex_memory_budget=_budget(prog, nv, 0.25))
    assert np.array_equal(res.values, mem.values)


@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
@pytest.mark.parametrize("app", ["sssp", "pagerank", "landmarks"])
def test_stored_interval_plan(app, seg_impl, planned_store):
    """On a store preprocessed with an interval plan the engine takes the
    tiles' footprint metadata (``_use_meta_fp``) and keeps the stored
    cuts; results equal the in-memory run and the reference's."""
    root = planned_store.root
    nv = TileStore(root).load_plan().num_vertices
    mk = APPS[app][0]
    budget = _budget(mk(tapps), nv, 0.1)
    mem = _port(root, mk(tapps), max_supersteps=60, seg_impl=seg_impl)
    eng = OutOfCoreEngine(TileStore(root), EngineConfig(
        device="cpu", num_servers=SERVERS, max_supersteps=60,
        seg_impl=seg_impl, vertex_memory_budget=budget))
    res = eng.run(mk(tapps))
    assert eng._use_meta_fp
    assert np.array_equal(eng._iv_splitter,
                          TileStore(root).load_interval_plan().splitter)
    assert np.array_equal(res.values, mem.values)
    want = _ref(root, mk(japps), max_supersteps=60,
                vertex_memory_budget=budget)
    _assert_match(app, res, want)


def test_ooc_dirty_interval_writeback(tmp_path, small_graph):
    """Late SSSP supersteps touch a shrinking frontier: some write back
    (and broadcast) fewer intervals than exist, and the last none — as in
    the reference, superstep by superstep."""
    nv, src, dst = small_graph
    val = np.random.default_rng(3).uniform(0.5, 2.0, len(src)).astype(
        np.float32)
    store = JTileStore(str(tmp_path / "w"))
    jspe.preprocess_arrays(src, dst, val, nv, store, tile_size=60,
                           num_intervals=6)
    res = _port(store.root, tapps.SSSP(source=0), vertex_memory_budget=nv)
    k = TileStore(store.root).load_interval_plan().num_intervals
    dirty = [h.vstate_dirty_intervals for h in res.history]
    assert any(0 < d < k for d in dirty)
    assert dirty[-1] == 0
    want = _ref(store.root, japps.SSSP(source=0), vertex_memory_budget=nv)
    assert dirty == [h.vstate_dirty_intervals for h in want.history]
    assert _fields(res, EXACT_STAT_FIELDS) == _fields(want, EXACT_STAT_FIELDS)


def _engine_after_run(small_store, interval_aware_order=True):
    store, plan, _ = small_store
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        device="cpu", num_servers=1, max_supersteps=2,
        vertex_memory_budget=plan.num_vertices,
        interval_aware_order=interval_aware_order))
    eng.run(tapps.PageRank(update_tol=1e-10))
    return eng


def test_interval_aware_order_is_a_permutation(small_store):
    eng = _engine_after_run(small_store)
    tids = list(eng.assignment[0])
    order = eng._order_joint_residency(0, tids)
    assert sorted(order) == sorted(tids)
    assert all(t in eng._tile_iv_ids for t in tids)
    jeng = JEngine(JTileStore(small_store[0].root), JConfig(
        num_servers=1, max_supersteps=2,
        vertex_memory_budget=small_store[1].num_vertices))
    jeng.run(japps.PageRank(update_tol=1e-10))
    assert order == jeng._order_joint_residency(0, tids)
    # the greedy falls back to the sweep past 256 tiles
    many = tids * (257 // len(tids) + 1)
    assert eng._order_joint_residency(0, many) == \
        eng._order_interval_sweep(many)


def test_interval_sweep_fallback(small_store):
    eng = _engine_after_run(small_store)
    tids = list(eng.assignment[0])
    order = eng._order_interval_sweep(tids)
    assert sorted(order) == sorted(tids)
    ivs = [int(eng._iv_t2i[t]) for t in order]
    assert ivs == sorted(ivs) or ivs == sorted(ivs, reverse=True)


def test_no_interval_order_keeps_results(small_store):
    store, plan, _ = small_store
    prog = tapps.MultiSourceBFS(sources=(0, 5, 17, 200))
    on = _port(store.root, prog, vertex_memory_budget=plan.num_vertices * 4)
    off = _port(store.root, prog, vertex_memory_budget=plan.num_vertices * 4,
                interval_aware_order=False)
    assert np.array_equal(on.values, off.values)


def test_engine_state_before_a_run(small_store):
    """The out-of-core fields exist from construction on (the reference
    sets them only when a session opens)."""
    store, _, _ = small_store
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(device="cpu"))
    assert eng.vstate is None and eng._ooc is False
    assert eng._vs_faults_cum == eng._vs_load_cum == eng._vs_spill_cum == 0


def test_spill_dir_cleaned_up(small_store):
    store, plan, _ = small_store
    before = set(os.listdir(store.root))
    res = _port(store.root, tapps.PageRank(update_tol=1e-10),
                vertex_memory_budget=plan.num_vertices)
    assert res.converged
    assert not any(d.startswith("_vstate_")
                   for d in set(os.listdir(store.root)) - before)
    # a session closed before it finished removes its spill tier too
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        device="cpu", vertex_memory_budget=plan.num_vertices))
    sess = eng.open_session(tapps.PageRank(update_tol=1e-10))
    sess.step()
    assert eng.vstate.stats.spills > 0
    sess.close()
    assert not any(d.startswith("_vstate_")
                   for d in set(os.listdir(store.root)) - before)


def test_cli_vertex_memory_budget(tmp_path, capsys):
    res = tgraph.main([
        "--app", "pagerank", "--graph", "banded", "--vertices", "2000",
        "--edges", "8000", "--tile-size", "512", "--servers", "2",
        "--supersteps", "4", "--vertex-memory-budget", "0.004",
        "--num-intervals", "4", "--store", str(tmp_path / "clistore"),
        "--device", "cpu"])
    assert any(h.vstate_dirty_intervals > 0 for h in res.history)
    assert sum(h.vstate_faults for h in res.history) > 0
    out = capsys.readouterr().out
    assert "vertex state [4 intervals, budget 0.004 MB]" in out
    mem = tgraph.main([
        "--app", "pagerank", "--vertices", "2000", "--supersteps", "4",
        "--store", str(tmp_path / "clistore"), "--reuse", "--servers", "2",
        "--device", "cpu", "--no-interval-order"])
    assert np.array_equal(res.values, mem.values)
