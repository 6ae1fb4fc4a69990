"""Mid-run query admission in the port, against itself and the JAX package.

The invariant: a query admitted into a ``[V, Q]`` slot at superstep k is
bit-identical to a fresh single-query run, and its per-query superstep
count is measured from its own admission.  It holds in every port mode
(serial, pipelined, stacked, merged, out-of-core vertex state) for PPR,
MultiSourceBFS and LandmarkDistances.  The session API: slot reuse never
leaks a prior column's state, drains freeze partial values, a session
with zero live columns steps on until a scheduled admission arrives, the
slot cap holds, and ``admit()`` may come from another thread.

Against the reference (``JAX_PLATFORMS=cpu``, ``seg_impl="jnp"``) the
``admit_plan`` runs match by the port's rules: MultiSourceBFS and
LandmarkDistances ``array_equal`` with ``per_query_supersteps`` and the
admission stats equal; PPR within ``rtol=1e-5, atol=1e-6`` after a
fixed number of supersteps (another order of summation, and its
``update_tol`` lies below float32 resolution, so its retirement
superstep may differ).  The port runs on ``device="cpu"``.
"""
import tempfile
import threading

import numpy as np
import pytest

from repro.core import apps as japps
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import OutOfCoreEngine as JEngine
from repro.graphio import spe
from repro.graphio.formats import TileStore as JTileStore
from repro_torch.core import apps as tapps
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio.formats import TileStore
from repro_torch.launch import graph as tgraph
from repro_torch.launch.cluster import parse_admit_plan

SS = 120   # enough for every app here to converge on the test graphs
PR_TOL = dict(rtol=1e-5, atol=1e-6)
PPR_STEPS = 10
OOC = dict(vertex_memory_budget=48 * 1024, num_intervals=4)


def _make_store(weighted, seed=7, nv=220, ne=1400, tile_size=96):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    _, i = np.unique(src * nv + dst, return_index=True)
    src, dst = src[i], dst[i]
    val = (rng.uniform(0.1, 10.0, len(src)).astype(np.float32)
           if weighted else None)
    root = tempfile.mkdtemp(prefix=f"admit_store_{int(weighted)}_")
    spe.preprocess_arrays(src, dst, val, nv, JTileStore(root), tile_size)
    return root


@pytest.fixture(scope="module")
def stores():
    return _make_store(False), _make_store(True)


# (app, initial seeds, admitted seed, admission superstep)
CASES = [
    ("ppr", (1, 7, 50), 77, 2),
    ("msbfs", (2, 11, 60), 77, 1),
    ("landmarks", (0, 9, 33), 77, 1),
]

MODES = {
    "serial": {},
    "pipelined": dict(pipeline=True, stack_size=2),
    "stacked": dict(engine_mode="stacked", device_budget_bytes=1 << 14),
    "merged": dict(engine_mode="merged"),
    "ooc": OOC,
}


def _root(stores, app):
    return stores[1] if app == "landmarks" else stores[0]


def _cfg(**kw):
    return EngineConfig(**dict(dict(device="cpu", num_servers=2,
                                    max_supersteps=SS), **kw))


def _run(root, prog, **kw):
    return OutOfCoreEngine(TileStore(root), _cfg(**kw)).run(prog)


def _ref(root, prog, **kw):
    cfg = JConfig(**dict(dict(seg_impl="jnp", num_servers=2,
                              max_supersteps=SS), **kw))
    return JEngine(JTileStore(root), cfg).run(prog)


def _session(root, prog, *, q_slots=None, **kw):
    eng = OutOfCoreEngine(TileStore(root), _cfg(**kw))
    return eng.open_session(prog, q_slots=q_slots)


def _tapp(app):
    return tapps.APPS[app]()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("app,init,seed,at", CASES,
                         ids=[c[0] for c in CASES])
def test_admitted_query_bit_identical(stores, app, init, seed, at, mode):
    root = _root(stores, app)
    kw = MODES[mode]
    fresh = _run(root, _tapp(app).with_queries((seed,)), **kw)
    assert fresh.converged
    batch = _run(root, _tapp(app).with_queries(init),
                 admit_plan=((at, (seed,)),), **kw)
    gq = len(init)           # the admitted query numbers after the batch
    assert batch.converged
    assert np.array_equal(batch.values[:, gq], fresh.values[:, 0])
    assert batch.per_query_supersteps[gq] == fresh.per_query_supersteps[0]
    assert batch.history[at].admitted_queries == (gq,)
    assert batch.history[at + 1].active_queries >= 1
    # the original batch is untouched by the splice, and every mode gives
    # the serial run's bits
    plain = _run(root, _tapp(app).with_queries(init), **kw)
    assert np.array_equal(batch.values[:, :gq], plain.values)
    serial = _run(root, _tapp(app).with_queries(init),
                  admit_plan=((at, (seed,)),))
    assert np.array_equal(batch.values, serial.values)
    assert np.array_equal(batch.per_query_supersteps,
                          serial.per_query_supersteps)


@pytest.mark.parametrize("ooc", [False, True], ids=["mem", "ooc"])
@pytest.mark.parametrize("app,init,seed,at", CASES,
                         ids=[c[0] for c in CASES])
def test_admit_plan_matches_reference(stores, app, init, seed, at, ooc):
    root = _root(stores, app)
    kw = dict(OOC) if ooc else {}
    plan = ((at, (seed,)), (at + 2, (seed + 1, seed + 2)))
    steps = {"max_supersteps": PPR_STEPS} if app == "ppr" else {}
    cfg = dict(kw, admit_plan=plan, **steps)
    got = _run(root, _tapp(app).with_queries(init), **cfg)
    want = _ref(root, japps.APPS[app]().with_queries(init), **cfg)
    fields = ("active_queries", "admitted_queries", "drained_queries",
              "tiles_processed")
    if app == "ppr":
        np.testing.assert_allclose(got.values, want.values, **PR_TOL)
        assert got.supersteps == want.supersteps == PPR_STEPS
    else:
        assert np.array_equal(got.values, want.values)
        assert np.array_equal(got.per_query_supersteps,
                              want.per_query_supersteps)
        fields += ("retired_queries", "updated_pairs", "updated_per_query",
                   "raw_bytes", "vstate_dirty_intervals")
    assert [[getattr(h, f) for f in fields] for h in got.history] == \
        [[getattr(h, f) for f in fields] for h in want.history]


@pytest.mark.parametrize("ooc", [False, True], ids=["mem", "ooc"])
def test_slot_reuse_never_leaks(stores, ooc):
    """admit → retire → admit through one slot: each new column matches a
    fresh run exactly (no residue of the prior occupant's values, aux or
    convergence state)."""
    kw = dict(OOC) if ooc else {}
    root = stores[0]
    seeds = [3, 41, 77, 105, 9]
    fresh = {s: _run(root, tapps.MultiSourceBFS(sources=(s,)), **kw)
             for s in seeds}
    sess = _session(root, tapps.MultiSourceBFS(sources=(seeds[0],)),
                    q_slots=1, **kw)
    for s in seeds[1:]:
        sess.admit([s])
    while not sess.finished:
        assert sess.step().active_queries <= 1
    res = sess.result()
    assert res.converged
    for gq, s in enumerate(seeds):
        assert np.array_equal(res.values[:, gq], fresh[s].values[:, 0]), s
        assert (res.per_query_supersteps[gq]
                == fresh[s].per_query_supersteps[0]), s
        assert sess.query_seeds[gq] == s


@pytest.mark.parametrize("ooc", [False, True], ids=["mem", "ooc"])
def test_drain_freezes_partial_column(stores, ooc):
    """A column drained after its third superstep holds a 3-superstep run
    of its query, and never reports a convergence count."""
    kw = dict(OOC) if ooc else {}
    root = stores[0]
    sess = _session(root, tapps.PersonalizedPageRank(seeds=(1, 7)), **kw)
    sess.step()
    sess.step()
    sess.drain([1])
    stats = sess.step()
    assert stats.drained_queries == (1,)
    assert sess.active_queries == (0,)
    assert sess.query_supersteps(1) == -1
    partial = sess.query_result(1)
    three = _run(root, tapps.PersonalizedPageRank(seeds=(7,)),
                 max_supersteps=3)
    assert np.array_equal(partial, three.values[:, 0])
    while not sess.finished:
        sess.step()
    res = sess.result()
    assert np.array_equal(res.values[:, 1], partial)
    assert res.per_query_supersteps[1] == -1
    ref = _run(root, tapps.PersonalizedPageRank(seeds=(1, 7)))
    assert np.array_equal(res.values[:, 0], ref.values[:, 0])
    assert res.per_query_supersteps[0] == ref.per_query_supersteps[0]
    # draining a query that is not live (retired, unknown) does nothing
    sess2 = _session(root, tapps.MultiSourceBFS(sources=(2, 11)))
    sess2.drain([5])
    assert sess2.step().drained_queries == ()


@pytest.mark.parametrize("ooc", [False, True], ids=["mem", "ooc"])
def test_zero_live_columns_wait_for_scheduled_admission(stores, ooc):
    """A session whose columns all retired keeps stepping (barrier only,
    no tile, no kernel) until a scheduled admission refills it; the late
    query still matches a fresh run bit for bit."""
    kw = dict(OOC) if ooc else {}
    root = stores[0]
    fresh = _run(root, tapps.MultiSourceBFS(sources=(77,)), **kw)
    gap_at = 20
    res = _run(root, tapps.MultiSourceBFS(sources=(2,)),
               admit_plan=((gap_at, (77,)),), **kw)
    assert res.converged
    gap = [h for h in res.history if h.active_queries == 0]
    assert gap, "expected idle supersteps between retirement and admission"
    assert all(h.tiles_processed == 0 and h.updated_pairs == 0
               and h.raw_bytes == 0 and h.vstate_dirty_intervals == 0
               for h in gap)
    assert res.history[gap_at].admitted_queries == (1,)
    assert np.array_equal(res.values[:, 1], fresh.values[:, 0])
    assert res.per_query_supersteps[1] == fresh.per_query_supersteps[0]


def test_admit_respects_slot_cap(stores):
    """Live admissions beyond q_slots queue until retirement frees a slot;
    nothing is lost, and each admitted column equals its fresh run."""
    root = stores[0]
    sess = _session(root, tapps.MultiSourceBFS(sources=(2, 11)), q_slots=2)
    gqs = sess.admit([77, 105, 9])
    assert gqs == [2, 3, 4]
    assert sess.free_slots == 0
    assert sess.superstep == 0
    seen = set()
    while not sess.finished:
        stats = sess.step()
        assert stats.active_queries <= 2
        seen.update(stats.admitted_queries)
    assert seen == {2, 3, 4}
    assert sess.superstep == len(sess.history)
    res = sess.result()
    assert res.converged
    for gq, s in zip(gqs, (77, 105, 9)):
        fresh = _run(root, tapps.MultiSourceBFS(sources=(s,)))
        assert np.array_equal(res.values[:, gq], fresh.values[:, 0])
        assert sess.query_supersteps(gq) == fresh.per_query_supersteps[0]


def test_admit_from_another_thread(stores):
    """admit() runs on a submitting thread while the driver thread steps;
    every queued query is admitted once and matches its fresh run."""
    root = stores[0]
    sess = _session(root, tapps.MultiSourceBFS(sources=(2, 11)), q_slots=3)
    seeds = [77, 105, 9, 41]
    gqs: list = []
    started = threading.Event()

    def submit():
        started.set()
        for s in seeds:
            gqs.extend(sess.admit([s]))

    t = threading.Thread(target=submit)
    t.start()
    started.wait()
    sess.step()
    t.join()
    while not sess.finished:
        sess.step()
    res = sess.result()
    assert sorted(gqs) == [2, 3, 4, 5]
    admitted = [g for h in res.history for g in h.admitted_queries]
    assert sorted(admitted) == [2, 3, 4, 5]
    for g, s in zip(gqs, seeds):
        fresh = _run(root, tapps.MultiSourceBFS(sources=(s,)))
        assert np.array_equal(res.values[:, g], fresh.values[:, 0])


def test_single_query_sessions_take_no_admission(stores):
    root = stores[0]
    sess = _session(root, tapps.BFS())
    assert sess.free_slots == 0 and sess.active_queries == ()
    with pytest.raises(RuntimeError, match="batched"):
        sess.admit([3])
    res = _run(root, tapps.BFS(), admit_plan=((0, (3,)),))
    assert res.values.ndim == 1 and res.per_query_supersteps is None


def test_parse_admit_plan():
    assert parse_admit_plan(None) is None
    assert parse_admit_plan(["4:17,42", "1:3"]) == ((1, (3,)),
                                                    (4, (17, 42)))
    with pytest.raises(SystemExit, match="SS:seed"):
        parse_admit_plan(["x"])


@pytest.mark.parametrize("extra", [[], ["--vertex-memory-budget", "0.02",
                                        "--num-intervals", "3"]],
                         ids=["mem", "ooc"])
def test_cli_admit(tmp_path, capsys, extra):
    argv = ["--app", "msbfs", "--seeds", "0,5", "--vertices", "2000",
            "--edges", "20000", "--tile-size", "4096", "--servers", "2",
            "--supersteps", "60", "--store", str(tmp_path / "s"),
            "--device", "cpu", "--admit", "1:17", "--admit", "2:42,7"]
    res = tgraph.main(argv + extra)
    assert res.converged
    assert res.values.shape[1] == 5
    assert [h.admitted_queries for h in res.history[1:3]] == [(2,), (3, 4)]
    fresh = tgraph.main(["--app", "msbfs", "--seeds", "42",
                         "--store", str(tmp_path / "s"), "--reuse",
                         "--servers", "2", "--device", "cpu"])
    assert np.array_equal(res.values[:, 3], fresh.values[:, 0])
    assert "queries in one edge pass" in capsys.readouterr().out
