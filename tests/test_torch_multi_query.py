"""The port's batched ``[V, Q]`` programs against the JAX package's, and the
multi-query invariants inside the port.

Both engines read one tile store written by ``repro.graphio.spe``; the
port runs on ``device="cpu"`` (the kernels' plain versions).

Tolerances.  MultiSourceBFS and LandmarkDistances are ``array_equal`` to
the reference, with ``per_query_supersteps`` and every multi-query stats
field equal.  PersonalizedPageRank is held to ``rtol=1e-5, atol=1e-6``
(the port sums a row in another order than XLA, which may also contract
the apply into an FMA).  Its ``update_tol`` of 1e-9 lies below float32's
resolution at its values, so a column retires when its float32 iteration
reaches a fixed point, which depends on that order: PPR's stats are held
equal over the first 10 supersteps, before any cell nears its fixed point,
and ``wire_bytes`` (compressed value bits) is not compared for it.

Inside the port everything is bit-exact: a batched column equals its solo
run; engine modes, pipelining and cache policies give one result.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import apps as japps
from repro.core import comm as jcomm
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import OutOfCoreEngine as JEngine
from repro.graphio import spe as jspe
from repro.graphio.formats import TileStore as JTileStore
from repro_torch.core import apps as tapps
from repro_torch.core import comm as tcomm
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio.formats import TileStore
from repro_torch.launch import graph as tgraph

PR_TOL = dict(rtol=1e-5, atol=1e-6)
SEEDS = (0, 5, 17, 111)
PPR_STAT_STEPS = 10
BATCHED = {"ppr": ("PersonalizedPageRank", "seeds"),
           "msbfs": ("MultiSourceBFS", "sources"),
           "landmarks": ("LandmarkDistances", "landmarks")}
STAT_FIELDS = ("active_queries", "updated_pairs", "updated_per_query",
               "retired_queries", "updated_vertices", "raw_bytes",
               "wire_bytes")


def _prog(pkg, app, seeds=SEEDS):
    cls, field = BATCHED[app]
    return getattr(pkg, cls)(**{field: tuple(seeds)})


@pytest.fixture(scope="module")
def weighted_store(small_graph, tmp_path_factory):
    nv, src, dst = small_graph
    val = np.random.default_rng(3).uniform(0.5, 2.0, len(src)).astype(
        np.float32)
    store = JTileStore(str(tmp_path_factory.mktemp("wstore")))
    jspe.preprocess_arrays(src, dst, val, nv, store, tile_size=100)
    return store


@pytest.fixture(scope="module")
def chain_store(tmp_path_factory):
    """A 50-vertex path 0->1->...->40 plus isolated vertices 41..49: BFS
    from 0 needs 40 supersteps, BFS from the isolated 45 converges
    immediately."""
    nv = 50
    store = JTileStore(str(tmp_path_factory.mktemp("chain")))
    jspe.preprocess_arrays(np.arange(0, 40), np.arange(1, 41), None, nv,
                           store, tile_size=16)
    return store


def _store_for(app, small_store, weighted_store):
    return weighted_store if app == "landmarks" else small_store[0]


def _port(root, prog, max_supersteps=200, **kw):
    cfg = EngineConfig(device="cpu", max_supersteps=max_supersteps, **kw)
    return OutOfCoreEngine(TileStore(root), cfg).run(prog)


def _ref(root, prog, max_supersteps=200, **kw):
    cfg = JConfig(seg_impl="jnp", max_supersteps=max_supersteps, **kw)
    return JEngine(JTileStore(root), cfg).run(prog)


def _stats(res, fields=STAT_FIELDS, steps=None):
    return [[getattr(h, f) for f in fields] for h in res.history[:steps]]


# ---------------------------------------------------------------------------
# the batched apps against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(small_store, weighted_store):
    """{(app, servers): (run to convergence, PPR_STAT_STEPS-step run)}
    from the JAX engine."""
    out = {}
    for app in BATCHED:
        root = _store_for(app, small_store, weighted_store).root
        for servers in (1, 2):
            full = _ref(root, _prog(japps, app), num_servers=servers)
            short = _ref(root, _prog(japps, app), num_servers=servers,
                         max_supersteps=PPR_STAT_STEPS)
            out[app, servers] = (full, short)
    return out


@pytest.mark.parametrize("app", sorted(BATCHED))
@pytest.mark.parametrize("servers", [1, 2])
@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
def test_batched_app_matches_reference(app, servers, seg_impl, reference,
                                       small_store, weighted_store):
    root = _store_for(app, small_store, weighted_store).root
    want, want_short = reference[app, servers]
    got = _port(root, _prog(tapps, app), num_servers=servers,
                seg_impl=seg_impl)
    assert got.converged and want.converged
    assert got.values.shape == want.values.shape == (300, len(SEEDS))
    assert got.values.dtype == np.float32
    if app == "ppr":
        np.testing.assert_allclose(got.values, want.values, **PR_TOL)
        short = _port(root, _prog(tapps, app), num_servers=servers,
                      seg_impl=seg_impl, max_supersteps=PPR_STAT_STEPS)
        np.testing.assert_allclose(short.values, want_short.values, **PR_TOL)
        fields = STAT_FIELDS[:-1]
        assert _stats(short, fields) == _stats(want_short, fields)
    else:
        assert np.array_equal(got.values, want.values)
        assert np.array_equal(got.per_query_supersteps,
                              want.per_query_supersteps)
        assert got.supersteps == want.supersteps
        assert _stats(got) == _stats(want)


# ---------------------------------------------------------------------------
# invariants inside the port, bit-exact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solo(small_store, weighted_store):
    """{(app, seed): single-query port run} (Q = 1 batched programs)."""
    out = {}
    for app in BATCHED:
        root = _store_for(app, small_store, weighted_store).root
        for s in SEEDS:
            out[app, s] = _port(root, _prog(tapps, app, (s,)),
                                num_servers=3)
    return out


@pytest.mark.parametrize("app", sorted(BATCHED))
@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
def test_batched_column_equals_solo_run(app, seg_impl, solo, small_store,
                                        weighted_store):
    root = _store_for(app, small_store, weighted_store).root
    rb = _port(root, _prog(tapps, app), num_servers=3, seg_impl=seg_impl)
    assert rb.converged
    for q, s in enumerate(SEEDS):
        assert np.array_equal(rb.values[:, q], solo[app, s].values[:, 0])
        # a column retires exactly when its solo run converges
        assert rb.per_query_supersteps[q] == solo[app, s].supersteps


@pytest.mark.parametrize("app", ["msbfs", "ppr"])
@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("engine_mode", ["tiled", "stacked", "merged"])
@pytest.mark.parametrize("cache_policy", ["lru", "tiered", "cost-aware"])
def test_mode_matrix_bit_identical(app, pipeline, engine_mode, cache_policy,
                                   solo, small_store):
    """Serial/pipelined x tiled/stacked/merged x every cache policy give
    the solo results per column, and one history of updates.  (Wire bytes
    may differ between modes: a dense column ships the cells of rows other
    columns updated — their old values from a tile, 0 from a stack or a
    merged list — as in the reference.)"""
    store, _, _ = small_store
    kw = dict(num_servers=3, pipeline=pipeline, engine_mode=engine_mode,
              cache_policy=cache_policy, prefetch_depth=3,
              prefetch_workers=2, stack_size=2)
    if cache_policy != "lru":
        kw["cache_capacity_bytes"] = 8_000   # room for some tiles only
    rb = _port(store.root, _prog(tapps, app), **kw)
    base = _port(store.root, _prog(tapps, app), num_servers=3)
    for q, s in enumerate(SEEDS):
        assert np.array_equal(rb.values[:, q], solo[app, s].values[:, 0])
    assert np.array_equal(rb.per_query_supersteps, base.per_query_supersteps)
    fields = ("updated_pairs", "updated_per_query", "retired_queries",
              "raw_bytes")
    assert _stats(rb, fields) == _stats(base, fields)


@pytest.mark.parametrize("skip_filter", ["bitmap", "bloom"])
@pytest.mark.parametrize("app", ["landmarks", "msbfs"])
def test_tile_skipping_with_batched_queries(app, skip_filter, small_store,
                                            weighted_store):
    """Tile skipping keys on the union of active vertices across live
    query columns: results equal a no-skip run, and with bloom filters
    (near-exact membership over 300 vertices) tiles are skipped once the
    joint frontier thins."""
    root = _store_for(app, small_store, weighted_store).root
    r_skip = _port(root, _prog(tapps, app), num_servers=3,
                   skip_density_threshold=0.9, block_shift=2,
                   skip_filter=skip_filter)
    r_ref = _port(root, _prog(tapps, app), num_servers=3,
                  tile_skipping=False)
    assert np.array_equal(r_skip.values, r_ref.values)
    assert np.array_equal(r_skip.per_query_supersteps,
                          r_ref.per_query_supersteps)
    if skip_filter == "bloom":
        assert sum(h.tiles_skipped for h in r_skip.history) > 0
    want = _ref(root, _prog(japps, app), num_servers=3,
                skip_density_threshold=0.9, block_shift=2,
                skip_filter=skip_filter)
    assert ([h.tiles_skipped for h in r_skip.history]
            == [h.tiles_skipped for h in want.history])


def test_query_retirement_excludes_converged_columns(chain_store):
    root = chain_store.root
    rb = _port(root, _prog(tapps, "msbfs", (0, 45)), num_servers=2)
    assert rb.converged
    # the isolated-source query produces zero updates in superstep 0 and
    # retires there; the chain query runs on alone
    assert rb.history[0].active_queries == 2
    assert rb.history[0].retired_queries == (1,)
    assert rb.history[0].updated_per_query[1] == 0
    assert rb.per_query_supersteps[1] == 1
    for h in rb.history[1:]:
        assert h.active_queries == 1
        assert set(h.updated_per_query) == {0}
        assert h.retired_queries in ((), (0,))
        assert h.updated_pairs == h.updated_vertices  # one live column
    # after retirement the payload is byte-identical to a run that never
    # had the retired query
    rs = _port(root, _prog(tapps, "msbfs", (0,)), num_servers=2)
    assert rs.supersteps == rb.supersteps
    for hb, hs in zip(rb.history[1:], rs.history[1:]):
        assert (hb.raw_bytes, hb.wire_bytes) == (hs.raw_bytes, hs.wire_bytes)
    assert np.array_equal(rb.values[:, 0], rs.values[:, 0])
    assert rb.values[45, 1] == 0.0 and np.isinf(rb.values[0, 1])
    want = _ref(root, _prog(japps, "msbfs", (0, 45)), num_servers=2)
    assert np.array_equal(rb.values, want.values)
    assert _stats(rb) == _stats(want)


@pytest.mark.parametrize("seg_impl", ["fused", "segment"])
@pytest.mark.parametrize("engine_mode", ["tiled", "stacked", "merged"])
def test_ppr_staggered_retirement_keeps_each_teleport_column(
        seg_impl, engine_mode, chain_store):
    """PPR from (45, 0, 3): the isolated seed 45 retires first and the
    chain seeds later, at different supersteps, so the live columns shift
    left while seed_mass [V, Q] is compacted beside them.  A device copy
    of seed_mass left uncompacted would teleport column 0 to vertex 45;
    every column must equal its solo run bit for bit."""
    root = chain_store.root
    seeds = (45, 0, 3)
    rb = _port(root, _prog(tapps, "ppr", seeds), num_servers=2,
               seg_impl=seg_impl, engine_mode=engine_mode)
    assert rb.converged
    assert len(set(int(x) for x in rb.per_query_supersteps)) == 3
    for q, s in enumerate(seeds):
        rs = _port(root, _prog(tapps, "ppr", (s,)), num_servers=2)
        assert np.array_equal(rb.values[:, q], rs.values[:, 0])
        assert rb.per_query_supersteps[q] == rs.supersteps
    want = _ref(root, _prog(japps, "ppr", seeds), num_servers=2)
    np.testing.assert_allclose(rb.values, want.values, **PR_TOL)


def test_single_query_stats_unchanged(small_store):
    """Classic 1-D programs keep their stats semantics."""
    store, _, _ = small_store
    r = _port(store.root, tapps.PageRank(update_tol=1e-10))
    for h in r.history:
        assert h.active_queries == 1
        assert h.updated_pairs == h.updated_vertices
        assert h.updated_per_query == {}
        assert h.retired_queries == ()
    assert r.per_query_supersteps is None


def test_max_supersteps_flushes_live_columns(small_store):
    """Columns still live at max_supersteps land in the result with
    per_query_supersteps -1."""
    store, _, _ = small_store
    r = _port(store.root, _prog(tapps, "ppr"), max_supersteps=3)
    assert not r.converged and r.supersteps == 3
    assert list(r.per_query_supersteps) == [-1] * len(SEEDS)
    want = _ref(store.root, _prog(japps, "ppr"), max_supersteps=3)
    np.testing.assert_allclose(r.values, want.values, **PR_TOL)


@pytest.mark.parametrize("app", sorted(BATCHED))
def test_batched_programs_mirror_reference(app):
    """Same init state, query interface and FusedSpec as the reference."""
    tp, jp = _prog(tapps, app), _prog(japps, app)
    assert tp.num_queries == jp.num_queries == len(SEEDS)
    assert tp.queries == jp.queries == SEEDS
    assert tp.with_queries((3,)).queries == (3,)
    assert (dataclasses.asdict(tp.fused_spec())
            == dataclasses.asdict(jp.fused_spec()))
    deg = np.arange(300, dtype=np.float64) % 5
    ts, js = tp.init(300, deg, deg), jp.init(300, deg, deg)
    assert ts.keys() == js.keys()
    for k in ts:
        assert np.array_equal(ts[k], js[k])


# ---------------------------------------------------------------------------
# 2-D payloads and the accounting knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("density", [0.05, 0.6])
@pytest.mark.parametrize("nq", [1, 3])
def test_multi_query_payload_matches_reference(mode, density, nq):
    rng = np.random.default_rng(int(density * 100) + nq)
    nv = 3000
    values = rng.normal(size=(nv, nq)).astype(np.float32)
    updated = rng.random((nv, nq)) < density
    updated[:, -1] &= rng.random(nv) < 0.05    # one sparser column
    got = tcomm.multi_query_payload(values, updated, mode=mode)
    want = jcomm.multi_query_payload(values, updated, mode=mode)
    assert got == want
    assert (vars(tcomm.plan_broadcast(values, updated, mode=mode))
            == vars(jcomm.plan_broadcast(values, updated, mode=mode)))
    dec = tcomm.decode_multi_query_payload(got[0], nv, got[1], np.float32)
    jdec = jcomm.decode_multi_query_payload(got[0], nv, got[1], np.float32)
    for a, b in zip(dec, jdec):
        assert np.array_equal(a, b)
    idx, vals, msk = dec
    assert np.array_equal(idx, np.nonzero(updated.any(axis=1))[0])
    assert np.array_equal(msk, updated[idx])
    assert np.array_equal(vals[msk], values[idx][msk])


def test_broadcast_async_equals_inline():
    rng = np.random.default_rng(4)
    values = rng.normal(size=(500, 2)).astype(np.float32)
    updated = rng.random((500, 2)) < 0.1
    fut = tcomm.plan_broadcast_async(values, updated, compressor="zstd-3")
    assert vars(fut.result(timeout=60)) == vars(
        tcomm.plan_broadcast(values, updated, compressor="zstd-3"))


@pytest.mark.parametrize("nv", [1, 127, 1000, 4_194_304, 1 << 25])
def test_sparse_capacity_matches_reference(nv):
    assert tcomm.sparse_capacity(nv) == jcomm.sparse_capacity(nv)


@pytest.mark.parametrize("app", ["msbfs", "bfs"])
def test_sampled_accounting_matches_reference(app, small_store):
    """comm_accounting="sampled" measures every 4th superstep and
    estimates the rest (2-D sparse payloads at 12 bytes a cell): the
    estimates and the results equal the reference's."""
    store, _, _ = small_store
    prog = {"msbfs": lambda pkg: _prog(pkg, "msbfs"),
            "bfs": lambda pkg: pkg.BFS()}[app]
    got = _port(store.root, prog(tapps), num_servers=2,
                comm_accounting="sampled")
    want = _ref(store.root, prog(japps), num_servers=2,
                comm_accounting="sampled")
    assert np.array_equal(got.values, want.values)
    assert len(got.history) > 4
    assert ([(h.raw_bytes, h.wire_bytes) for h in got.history]
            == [(h.raw_bytes, h.wire_bytes) for h in want.history])
    full = _port(store.root, prog(tapps), num_servers=2)
    assert np.array_equal(got.values, full.values)


@pytest.mark.parametrize("skip_filter", ["bitmap", "bloom"])
def test_debug_skip_log_matches_reference(skip_filter, small_store):
    store, _, _ = small_store
    kw = dict(num_servers=2, skip_density_threshold=0.9, block_shift=2,
              skip_filter=skip_filter, debug_skip_log=True)
    teng = OutOfCoreEngine(TileStore(store.root),
                           EngineConfig(device="cpu", **kw))
    teng.run(_prog(tapps, "msbfs"))
    jeng = JEngine(JTileStore(store.root), JConfig(seg_impl="jnp", **kw))
    jeng.run(_prog(japps, "msbfs"))
    assert teng.skip_log and len(teng.skip_log) == len(jeng.skip_log)
    for g, w in zip(teng.skip_log, jeng.skip_log):
        assert g.keys() == w.keys()
        assert np.array_equal(g["active"], w["active"])
        assert [g[k] for k in ("superstep", "server", "run", "skipped")] == \
            [w[k] for k in ("superstep", "server", "run", "skipped")]
    off = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        device="cpu", **dict(kw, debug_skip_log=False)))
    off.run(_prog(tapps, "msbfs"))
    assert off.skip_log == []


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--app", "msbfs", "--queries", "3"],
    ["--app", "ppr", "--seeds", "0,5", "--pipeline", "--stack-size", "2"],
    ["--app", "landmarks", "--queries", "2", "--cache-policy", "tiered",
     "--cache-promote-hits", "1", "--static-order"]])
def test_cli_runs_batched_apps(argv, tmp_path, capsys):
    res = tgraph.main(argv + ["--vertices", "2000", "--edges", "20000",
                              "--tile-size", "4096", "--servers", "2",
                              "--supersteps", "60", "--store",
                              str(tmp_path / "s"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "queries in one edge pass" in out
    assert res.values.ndim == 2
    assert len(res.per_query_supersteps) == res.values.shape[1]


def test_cli_rejects_queries_for_single_query_apps():
    with pytest.raises(SystemExit, match="batched"):
        tgraph.main(["--app", "bfs", "--queries", "2", "--device", "cpu"])
