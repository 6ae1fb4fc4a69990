"""The port's pipelined, stacked and merged engine modes and its stacked
tile steps, on the CPU.

Inside the port every mode is bit-exact with the serial tiled loop (tiles
own disjoint row ranges, and a row's sum runs in the same order in every
mode).  Against the JAX package: the reference's pipelined and stacked
runs, on the same store — SSSP, WCC, BFS and InDegree ``array_equal`` with
equal per-superstep stats, PageRank within ``rtol=1e-5, atol=1e-6`` after
a fixed number of supersteps (another order of summation than XLA).
"""
import numpy as np
import pytest
import torch

from repro.core import apps as japps
from repro.core import distributed as jdist
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import OutOfCoreEngine as JEngine
from repro.graphio import spe as jspe
from repro.graphio.formats import TileStore as JTileStore
from repro_torch.core import apps as tapps
from repro_torch.core import distributed as tdist
from repro_torch.core import gab as tgab
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.core.tiles import stack_tiles, tile_edge_values
from repro_torch.graphio.formats import TileStore

PR_TOL = dict(rtol=1e-5, atol=1e-6)
PR_SUPERSTEPS = 15
APPS = ("pagerank", "sssp", "wcc", "bfs", "indegree")
MODES = [dict(pipeline=True), dict(engine_mode="stacked"),
         dict(engine_mode="merged"), dict(pipeline=True,
                                          engine_mode="stacked")]
MODE_IDS = ["pipelined", "stacked", "merged", "pipelined-stacked"]


def _prog(pkg, app):
    return {"pagerank": pkg.PageRank, "sssp": pkg.SSSP, "wcc": pkg.WCC,
            "bfs": pkg.BFS, "indegree": pkg.InDegree}[app]()


@pytest.fixture(scope="module")
def weighted_store(small_graph, tmp_path_factory):
    nv, src, dst = small_graph
    val = np.random.default_rng(3).uniform(0.5, 2.0, len(src)).astype(
        np.float32)
    store = JTileStore(str(tmp_path_factory.mktemp("wstore")))
    jspe.preprocess_arrays(src, dst, val, nv, store, tile_size=64)
    return store


def _store_for(app, small_store, weighted_store):
    return weighted_store if app == "sssp" else small_store[0]


def _port(root, prog, **kw):
    cfg = EngineConfig(device="cpu", num_servers=3, prefetch_depth=3,
                       prefetch_workers=2, stack_size=2, **kw)
    return OutOfCoreEngine(TileStore(root), cfg).run(prog)


def _max_ss(app):
    return PR_SUPERSTEPS if app == "pagerank" else 200


@pytest.fixture(scope="module")
def serial(small_store, weighted_store):
    """{(app, seg_impl): the port's serial tiled run}."""
    return {(app, impl): _port(_store_for(app, small_store,
                                          weighted_store).root,
                               _prog(tapps, app), seg_impl=impl,
                               max_supersteps=_max_ss(app))
            for app in APPS for impl in ("fused", "segment")}


_STATS = ("updated_vertices", "tiles_processed", "tiles_skipped",
          "raw_bytes", "wire_bytes", "network_bytes")


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
def test_mode_bit_identical_to_serial_tiled(app, mode, seg_impl, serial,
                                            small_store, weighted_store):
    root = _store_for(app, small_store, weighted_store).root
    got = _port(root, _prog(tapps, app), seg_impl=seg_impl,
                max_supersteps=_max_ss(app), **mode)
    want = serial[app, seg_impl]
    assert got.supersteps == want.supersteps
    assert np.array_equal(got.values, want.values)
    assert ([[getattr(h, f) for f in _STATS] for h in got.history]
            == [[getattr(h, f) for f in _STATS] for h in want.history])


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_mode_matches_reference(app, mode, small_store, weighted_store):
    root = _store_for(app, small_store, weighted_store).root
    want = JEngine(JTileStore(root), JConfig(
        seg_impl="jnp", num_servers=3, prefetch_depth=3, prefetch_workers=2,
        stack_size=2, max_supersteps=_max_ss(app), **mode)).run(
        _prog(japps, app))
    got = _port(root, _prog(tapps, app), max_supersteps=_max_ss(app),
                **mode)
    if app == "pagerank":
        np.testing.assert_allclose(got.values, want.values, **PR_TOL)
        return
    assert np.array_equal(got.values, want.values)
    stats = _STATS + ("cache_hit_ratio", "disk_bytes_read")
    assert ([[getattr(h, f) for f in stats] for h in got.history]
            == [[getattr(h, f) for f in stats] for h in want.history])


def test_pipelined_with_tile_skipping(weighted_store):
    """Skip filters and the pipelined path compose: the survivor list is
    prefetched, skipped tiles are never read."""
    kw = dict(skip_density_threshold=0.9, block_shift=2)
    ser = _port(weighted_store.root, tapps.SSSP(), **kw)
    pip = _port(weighted_store.root, tapps.SSSP(), pipeline=True, **kw)
    assert np.array_equal(ser.values, pip.values)
    assert sum(h.tiles_skipped for h in pip.history) > 0
    assert ([h.tiles_skipped for h in ser.history]
            == [h.tiles_skipped for h in pip.history])


def test_pipelined_small_cache_and_stall_accounting(small_store):
    """Under eviction pressure results stay exact and the stall/io-busy
    accounting stays sane (stall <= superstep wall time)."""
    store, plan, _ = small_store
    cap = sum(store.tile_disk_bytes(t) for t in range(plan.num_tiles)) // 3
    kw = dict(cache_capacity_bytes=cap, cache_mode=2)
    ser = _port(store.root, tapps.PageRank(update_tol=1e-10), **kw)
    pip = _port(store.root, tapps.PageRank(update_tol=1e-10), pipeline=True,
                **kw)
    assert np.array_equal(ser.values, pip.values)
    for h in pip.history:
        assert 0.0 <= h.stall_seconds <= h.seconds + 1e-6
        assert h.io_busy_seconds >= 0.0
    assert ([h.disk_bytes_read for h in ser.history]
            == [h.disk_bytes_read for h in pip.history])


def test_pipelined_stack_size_one(small_store):
    """stack_size=1 runs one tile a stack and stays exact."""
    store, _, _ = small_store
    ser = _port(store.root, tapps.PageRank(update_tol=1e-10))
    cfg = EngineConfig(device="cpu", num_servers=2, pipeline=True,
                       prefetch_depth=1, prefetch_workers=1, stack_size=1)
    pip = OutOfCoreEngine(TileStore(store.root), cfg).run(
        tapps.PageRank(update_tol=1e-10))
    assert np.array_equal(ser.values, pip.values)


def test_stacked_budget_streams_the_rest(small_store):
    """A device budget of two tiles a server keeps two resident and
    streams the rest tiled; results stay exact."""
    store, plan, _ = small_store
    budget = 2 * plan.edge_cap * 12
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        device="cpu", num_servers=2, engine_mode="stacked",
        device_budget_bytes=budget))
    res = eng.run(tapps.WCC())
    for s in eng.exec_servers:
        assert len(eng._stacks[s]["row_start"]) == 2
        assert eng._streamed[s] == eng.assignment[s][2:]
    want = _port(store.root, tapps.WCC())
    assert np.array_equal(res.values, want.values)


def test_merged_requires_ascending_dst(small_store):
    """The segment kernel binary-searches the merged dst list, so a server
    whose tiles are out of row order is refused, not misreduced."""
    store, _, _ = small_store
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        device="cpu", num_servers=1, engine_mode="merged"))
    eng.assignment = [list(reversed(eng.assignment[0]))]
    with pytest.raises(ValueError, match="ascending"):
        eng.run(tapps.BFS())


def test_engine_mode_names(small_store):
    store, _, _ = small_store
    with pytest.raises(ValueError, match="engine_mode"):
        OutOfCoreEngine(TileStore(store.root),
                        EngineConfig(device="cpu", engine_mode="sharded"))


# ---------------------------------------------------------------------------
# the stacked tile steps
# ---------------------------------------------------------------------------

def _state(prog, nv, q):
    state = prog.init(nv, np.arange(nv) % 4 + 1.0, np.ones(nv))
    return tgab.state_from_numpy(state, "cpu")


def _batched_or_1d(q):
    return (tapps.PageRank() if q is None
            else tapps.PersonalizedPageRank(seeds=tuple(range(0, 3 * q, 3))))


@pytest.mark.parametrize("q", [None, 3])
def test_run_tile_stack_padding_is_inert(q, small_store):
    store, plan, _ = small_store
    tiles = [store.read_tile(t) for t in range(min(3, plan.num_tiles))]
    prog = _batched_or_1d(q)
    aux = _state(prog, plan.num_vertices, q)
    values = aux.pop("value")
    plain = stack_tiles(tiles, plan.row_cap)
    padded = tdist.pad_stack_to(stack_tiles(tiles, plan.row_cap),
                                len(tiles) + 3)
    assert len(padded["row_start"]) == len(tiles) + 3
    m1, u1 = tgab.run_tile_stack(prog, values, aux, plain, plan.row_cap)
    m2, u2 = tgab.run_tile_stack(prog, values, aux, padded, plan.row_cap)
    assert torch.equal(u1, u2) and torch.equal(m1, m2)
    assert tuple(m1.shape) == tuple(values.shape)


@pytest.mark.parametrize("q", [None, 3])
@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
def test_run_tile_stack_matches_run_tile(q, seg_impl, small_store):
    """One stacked call == per-tile calls, bit for bit."""
    store, plan, _ = small_store
    nv = plan.num_vertices
    tiles = [store.read_tile(t) for t in range(plan.num_tiles)]
    prog = _batched_or_1d(q)
    aux = _state(prog, nv, q)
    values = aux.pop("value")
    masked, upd = tgab.run_tile_stack(prog, values, aux,
                                      stack_tiles(tiles, plan.row_cap),
                                      plan.row_cap, seg_impl)
    ref_masked = torch.zeros_like(values)
    ref_upd = torch.zeros(values.shape, dtype=torch.bool)
    for t in tiles:
        rows, new, u = tgab.run_tile(
            prog, values, aux, (t.src, t.dst_local, tile_edge_values(t)),
            t.meta.row_start, t.meta.num_rows, plan.row_cap, seg_impl)
        vm = u.any(dim=1) if u.ndim == 2 else u
        ref_masked[rows[vm]] = torch.where(u[vm], new[vm],
                                           ref_masked[rows[vm]])
        ref_upd[rows[vm]] |= u[vm]
    assert torch.equal(upd, ref_upd)
    assert torch.equal(masked[upd], ref_masked[upd])
    assert bool(upd.any())


@pytest.mark.parametrize("q", [None, 3])
def test_merged_step_matches_stacked_step(q, small_store):
    store, plan, _ = small_store
    nv = plan.num_vertices
    tiles = [store.read_tile(t) for t in range(plan.num_tiles)]
    prog = _batched_or_1d(q)
    aux = _state(prog, nv, q)
    values = aux.pop("value")
    src = np.concatenate([t.src[:t.meta.num_edges] for t in tiles])
    dst = np.concatenate([t.dst_local[:t.meta.num_edges] + t.meta.row_start
                          for t in tiles]).astype(np.int32)
    val = np.concatenate([tile_edge_values(t)[:t.meta.num_edges]
                          for t in tiles])
    owned = torch.ones(nv, dtype=torch.bool)
    m1, u1 = tgab.merged_server_step(
        prog, values, aux, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(val), owned)
    m2, u2 = tgab.run_tile_stack(prog, values, aux,
                                 stack_tiles(tiles, plan.row_cap),
                                 plan.row_cap)
    assert torch.equal(u1, u2) and torch.equal(m1, m2)


def test_stack_padding_helpers_match_reference(small_store):
    store, plan, _ = small_store
    tiles = [store.read_tile(t) for t in range(min(2, plan.num_tiles))]
    got = tdist.pad_stack_to(stack_tiles(tiles, plan.row_cap), 5)
    want = jdist.pad_stack_to(stack_tiles(tiles, plan.row_cap), 5)
    for k in ("src", "dst_local", "val", "row_start", "num_rows",
              "num_edges"):
        assert np.array_equal(got[k], want[k])
    for n, s in [(0, 4), (5, 4), (8, 4), (9, 1), (3, 7)]:
        assert tdist.pad_tile_count(n, s) == jdist.pad_tile_count(n, s)


def test_prefetch_workers_hand_back_host_tiles(small_store):
    """The pipelined engine's prefetch threads return numpy tiles only;
    tensors are made on the main thread."""
    store, plan, _ = small_store
    ts = TileStore(store.root)
    got = list(ts.prefetch_iter(range(plan.num_tiles), depth=2, workers=2))
    assert [t for t, _ in got] == list(range(plan.num_tiles))
    for _, tile in got:
        assert isinstance(tile.src, np.ndarray)
        assert isinstance(tile.dst_local, np.ndarray)
