"""Multi-tenant fair admission and the result cache of the port's service
(``repro_torch.serve.graph_service``), against itself and the JAX
package's.

The counterparts of ``tests/test_fair_admission.py``: deficit-round-robin
windows track the weights, a hot tenant cannot starve the others,
fractional weights admit within bounded rounds, idle tenants forfeit
credit; ``ResultCache`` hits are bit-identical defensive copies with LRU
eviction and counters, keyed by the graph fingerprint; a cache hit takes
no slot; the first admission window follows the weights end to end; and
the submit-vs-drain race drill.  Against the reference: the same backlog
and weights give the same DRR picks in the same order, with the same
credit left (hypothesis), and both packages give one store the same
``TileStore.fingerprint()``, so a cache key means the same graph in both.
The port runs on ``device="cpu"``.
"""
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # deterministic fallback, see _hypothesis_compat
    from _hypothesis_compat import given, settings, strategies as st

from repro.core.engine import EngineConfig as JConfig
from repro.graphio.formats import TileStore as JTileStore
from repro.serve.graph_service import GraphService as JService
from repro_torch.core.engine import EngineConfig
from repro_torch.graphio import spe
from repro_torch.graphio.formats import TileStore
from repro_torch.serve.graph_service import (GraphService, ResultCache,
                                             parse_tenants)

SS = 200
NV = 220


def _make_store(nv=NV, ne=1400, tile_size=96, seed=7):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    key = src * nv + dst
    _, i = np.unique(key, return_index=True)
    root = tempfile.mkdtemp(prefix="torch_fair_admission_store_")
    spe.preprocess_arrays(src[i], dst[i], None, nv, TileStore(root),
                          tile_size)
    store = TileStore(root)
    store.load_meta()
    return store


#: the module's store, shared with the hypothesis property (the shim's
#: @given cannot inject fixtures)
_LAZY: dict = {}


def _store_singleton():
    if "store" not in _LAZY:
        _LAZY["store"] = _make_store()
    return _LAZY["store"]


@pytest.fixture(scope="module")
def store():
    return _store_singleton()


def _cfg():
    return EngineConfig(num_servers=2, max_supersteps=SS, device="cpu")


def _svc(store, **kw):
    return GraphService(store, _cfg(), max_supersteps=SS, **kw)


# -- deficit round-robin windows ---------------------------------------------

def test_drr_shares_track_weights_within_one(store):
    """Every admission window of a sustained 3:1-weighted backlog splits
    within ±1 of weight-proportional (8 slots -> 6:2)."""
    svc = _svc(store, tenants={"a": 3.0, "b": 1.0})
    for i in range(48):
        svc.submit("ppr", i % NV, tenant="a")
    for i in range(16):
        svc.submit("ppr", i, tenant="b")
    with svc._lock:
        for _ in range(8):        # 8 windows x (6a + 2b) drains both
            batch = svc._drr_take("ppr", 8)
            n_a = sum(t.tenant == "a" for t in batch)
            assert len(batch) == 8
            assert abs(n_a - 6) <= 1, n_a
        assert svc._pending_count("ppr") == 0


def test_hot_tenant_cannot_starve_under_10x_skew(store):
    """Equal weights, 10x offered-load skew: the small tenant still gets
    half of every window while it is backlogged."""
    svc = _svc(store)             # no tenant map: everyone weight 1
    for i in range(100):
        svc.submit("msbfs", i % NV, tenant="hog")
    for i in range(10):
        svc.submit("msbfs", i, tenant="mouse")
    with svc._lock:
        for _ in range(5):
            batch = svc._drr_take("msbfs", 4)
            assert sum(t.tenant == "mouse" for t in batch) == 2


def test_fractional_weight_admits_within_bounded_rounds(store):
    """A weight-0.25 tenant accumulates credit across rounds and lands
    its weight-proportional share (5 slots at 1.0:0.25 -> 4:1)."""
    svc = _svc(store, tenants={"fast": 1.0, "slow": 0.25})
    for i in range(20):
        svc.submit("ppr", i, tenant="fast")
        svc.submit("ppr", 100 + i, tenant="slow")
    with svc._lock:
        batch = svc._drr_take("ppr", 5)
    assert sum(t.tenant == "fast" for t in batch) == 4
    assert sum(t.tenant == "slow" for t in batch) == 1


def test_idle_tenant_forfeits_banked_credit(store):
    """Credit banked while a tenant goes idle is dropped as soon as a
    later window runs without it (work-conserving fairness)."""
    svc = _svc(store, tenants={"a": 4.0, "b": 1.0})
    for i in range(3):
        svc.submit("ppr", i, tenant="a")
    for i in range(10):
        svc.submit("ppr", 10 + i, tenant="b")
    with svc._lock:
        svc._drr_take("ppr", 4)   # a admits all 3, banks 1.0 credit
        svc._drr_take("ppr", 2)   # a idle: its banked credit is cleared
        assert "a" not in svc._deficit["ppr"]


def test_parse_tenants_spec():
    assert parse_tenants("alice:3,bob:1") == {"alice": 3.0, "bob": 1.0}
    assert parse_tenants("solo") == {"solo": 1.0}
    assert parse_tenants(" a : 2 , b ") == {"a": 2.0, "b": 1.0}
    for bad in ("a:0", "a:-2", "", ":3", "a:x"):
        with pytest.raises(ValueError):
            parse_tenants(bad)


def test_service_rejects_nonpositive_weights_and_bad_seeds(store):
    with pytest.raises(ValueError):
        _svc(store, tenants={"a": 0.0})
    svc = _svc(store)
    with pytest.raises(ValueError):
        svc.submit("ppr", -1)
    with pytest.raises(ValueError):
        svc.submit("ppr", NV)
    with pytest.raises(ValueError):
        svc.submit("pagerank", 0)


# -- result cache -------------------------------------------------------------

def test_result_cache_bit_identity_and_defensive_copies():
    c = ResultCache(capacity=4)
    vals = np.array([np.pi, np.inf, -0.0, np.nan])
    frozen = vals.tobytes()
    c.put("ppr", 1, "fp", vals, 7)
    vals[0] = 99.0                       # caller mutates after put
    got, supersteps = c.get("ppr", 1, "fp")
    assert supersteps == 7
    assert got.tobytes() == frozen
    got[1] = 0.0                         # caller mutates the hit
    again, _ = c.get("ppr", 1, "fp")
    assert again.tobytes() == frozen


def test_result_cache_lru_eviction_and_counters():
    c = ResultCache(capacity=2)
    a = np.arange(3.0)
    c.put("ppr", 1, "fp", a, 1)
    c.put("ppr", 2, "fp", a, 2)
    assert c.get("ppr", 1, "fp") is not None   # touch: 2 becomes LRU
    c.put("ppr", 3, "fp", a, 3)                # evicts 2
    assert c.get("ppr", 2, "fp") is None
    assert c.get("ppr", 1, "fp") is not None
    assert c.get("ppr", 3, "fp") is not None
    assert c.snapshot() == dict(hits=3, misses=1, entries=2, capacity=2)


def test_result_cache_never_crosses_keys():
    c = ResultCache()
    c.put("ppr", 1, "fp-a", np.arange(3.0), 5)
    assert c.get("ppr", 1, "fp-b") is None     # other graph
    assert c.get("msbfs", 1, "fp-a") is None   # other app
    assert c.get("ppr", 2, "fp-a") is None     # other seed
    assert c.get("ppr", 1, "fp-a") is not None


def test_shared_cache_isolated_across_stores(store):
    """One ResultCache fronting two services over DIFFERENT graphs:
    each service hits only its own fingerprint's entries."""
    other = _make_store(seed=99)
    assert store.fingerprint() != other.fingerprint()
    cache = ResultCache(capacity=32)
    results = {}
    for name, s in (("one", store), ("two", other)):
        svc = GraphService(s, _cfg(), q_slots=2, max_wait_s=0.01,
                           max_supersteps=SS, result_cache=cache)
        svc.start()
        t = svc.submit("msbfs", 11)
        assert t.wait(120) and t.status == "done" and not t.cache_hit
        hit = svc.submit("msbfs", 11)
        assert hit.wait(120) and hit.cache_hit
        assert np.array_equal(hit.result, t.result)
        results[name] = t.result
        svc.request_drain()
        svc.join(120)
        assert not svc._thread.is_alive()
    # different graphs produced different columns, and neither service
    # ever saw the other's (a cross-fingerprint hit would have made the
    # second service's cold result equal the first's)
    assert not np.array_equal(results["one"], results["two"])


def test_cache_hit_consumes_no_slot(store):
    svc = _svc(store, q_slots=2, max_wait_s=0.01, result_cache=8)
    svc.start()
    try:
        t = svc.submit("ppr", 5)
        assert t.wait(120) and t.status == "done"
        opened = svc.stats_snapshot()["stats"]["sessions_opened"]
        hit = svc.submit("ppr", 5)
        assert hit.cache_hit and hit.status == "done" and hit.wait(0)
        assert hit.supersteps == t.supersteps
        assert np.array_equal(hit.result, t.result)
        snap = svc.stats_snapshot()["stats"]
        assert snap["sessions_opened"] == opened    # no admission happened
        assert snap["cache_hits"] == 1
        assert snap["cache_misses"] == 1
    finally:
        svc.request_drain()
        svc.join(120)


# -- weighted fairness end-to-end ---------------------------------------------

def test_first_admission_window_respects_weights_end_to_end(store):
    """Queue 3:1-weighted tenants before the serve loop starts: the
    session's opening batch is the DRR split, and everyone completes."""
    svc = _svc(store, q_slots=4, max_wait_s=0.01,
               tenants={"gold": 3.0, "free": 1.0})
    golds = [svc.submit("msbfs", i, tenant="gold") for i in range(8)]
    frees = [svc.submit("msbfs", 50 + i, tenant="free") for i in range(8)]
    svc.start()
    try:
        for t in golds + frees:
            assert t.wait(120) and t.status == "done", t
        ts = svc.stats_snapshot()["tenants"]
        assert ts["gold"] == dict(submitted=8, admitted=8, done=8,
                                  refused=0)
        assert ts["free"] == dict(submitted=8, admitted=8, done=8,
                                  refused=0)
        # the 4 tickets sharing the earliest admission timestamp are the
        # opening batch — DRR split 3 gold : 1 free
        first = sorted(golds + frees, key=lambda t: t.admitted_s)[:4]
        assert sum(t.tenant == "gold" for t in first) == 3
    finally:
        svc.request_drain()
        svc.join(120)


# -- submit-vs-drain race drill -----------------------------------------------

def test_submit_vs_drain_race_drill(store):
    """Threads storm submit() while the service drains: every call ends
    in a resolved ticket or a clean RuntimeError, and the drain
    invariant submitted == done+timeout+failed+refused holds with no
    ticket leaked in a pending queue.  A short switch interval makes the
    threads interleave more often."""
    svc = _svc(store, q_slots=4, max_wait_s=0.005)
    svc.start()
    tickets, refusals, unexpected = [], [], []
    tlock = threading.Lock()
    stop = threading.Event()

    def storm(tid):
        rng = np.random.default_rng(tid)
        while not stop.is_set():
            try:
                t = svc.submit("msbfs", int(rng.integers(NV)),
                               tenant=f"t{tid % 3}")
                with tlock:
                    tickets.append(t)
            except RuntimeError:          # clean refusal: drain latched
                with tlock:
                    refusals.append(tid)
                return
            except Exception as e:        # pragma: no cover - must not happen
                with tlock:
                    unexpected.append(e)
                return
            time.sleep(0.003)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=storm, args=(i,))
                   for i in range(5)]
        for th in threads:
            th.start()
        time.sleep(0.4)
        svc.request_drain()
        time.sleep(0.3)                   # give every storm a post-drain try
        stop.set()
        for th in threads:
            th.join(60)
        svc.join(180)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not svc._thread.is_alive()
    assert not unexpected, unexpected
    assert refusals, "no thread observed the drain refusal"
    for t in tickets:
        assert t.wait(60), t
        assert t.status in ("done", "timeout", "failed"), t
    s = svc.stats_snapshot()
    stats = s["stats"]
    assert stats["submitted"] == (stats["done"] + stats["timeout"]
                                  + stats["failed"] + stats["refused"])
    assert stats["submitted"] == len(tickets) + len(refusals)
    assert stats["refused"] == len(refusals)
    assert all(n == 0 for n in s["pending"].values())


# -- parity with the reference ------------------------------------------------

@given(st.lists(st.tuples(st.sampled_from(["a", "b", "c", "d"]),
                          st.integers(0, NV - 1)), min_size=0, max_size=40),
       st.lists(st.sampled_from([0.25, 0.5, 1.0, 1.5, 2.0, 3.0]),
                min_size=4, max_size=4),
       st.lists(st.integers(1, 9), min_size=1, max_size=8),
       st.sampled_from([True, False]))
@settings(max_examples=60, deadline=None)
def test_drr_take_equals_reference(backlog, weights, windows, weighted):
    """The same backlog, weights and admission windows through both
    packages' ``_drr_take``: the same tickets (rid, tenant, seed) in the
    same order each window, and the same credit left after each."""
    store = _store_singleton()
    tenants = dict(zip("abcd", weights)) if weighted else None
    port = GraphService(store, _cfg(), tenants=tenants)
    ref = JService(JTileStore(store.root), JConfig(num_servers=2),
                   tenants=tenants)
    for svc in (port, ref):
        for tenant, seed in backlog:
            svc.submit("msbfs", seed, tenant=tenant)
    for k in windows:
        picks = []
        for svc in (port, ref):
            with svc._lock:
                batch = svc._drr_take("msbfs", k)
                picks.append(([(t.rid, t.tenant, t.seed) for t in batch],
                              dict(svc._deficit.get("msbfs", {})),
                              svc._pending_count("msbfs")))
        assert picks[0] == picks[1], k


def test_fingerprint_equals_reference(store):
    """One store, one fingerprint in both packages (and a second store
    another), so a result-cache key names the same graph in both."""
    other = _make_store(seed=99)
    for s in (store, other):
        assert TileStore(s.root).fingerprint() == JTileStore(
            s.root).fingerprint()
    assert store.fingerprint() != other.fingerprint()
    port = GraphService(TileStore(store.root), _cfg())
    ref = JService(JTileStore(store.root), JConfig(num_servers=2))
    assert port.fingerprint == ref.fingerprint
    assert port.num_vertices == ref.num_vertices == NV
