"""The port's HTTP frontend (``repro_torch.serve.http``) against itself and
the JAX package's.

The counterparts of ``tests/test_serve_http.py``:

  * a real ``repro_torch.launch.graph --serve-http --device cpu``
    subprocess driven by threaded ``urllib`` clients — HTTP-served results
    are **byte-identical** to direct ``GraphService.submit`` and to a clean
    ``run()`` in the port;
  * SIGTERM mid-load: in-flight queries finish, new submits get 503, the
    stats invariant ``submitted == done+timeout+failed+refused`` holds at
    drain, exit code 0;
  * request-schema properties (hypothesis, with the in-repo shim
    fallback): arbitrary bodies never crash the handler thread;
  * ``site=http_response`` fault injection through the port's
    ``runtime/faults.py``: a dropped response leaves service state
    consistent, a delayed one arrives late but intact;
  * the stats/healthz lifecycle.

Against the reference: ``encode_array``, ``decode_array`` and
``parse_query_body`` give the same results and errors on the same inputs
(hypothesis over bodies), and the two frontends answer the same requests
with the same statuses and bodies.  The port runs on ``device="cpu"``.
"""
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # deterministic fallback, see _hypothesis_compat
    from _hypothesis_compat import given, settings, strategies as st

from repro.core.engine import EngineConfig as JConfig
from repro.graphio.formats import TileStore as JTileStore
from repro.serve import http as jhttp
from repro.serve.graph_service import GraphService as JService
from repro_torch.core.apps import APPS
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio import spe
from repro_torch.graphio.formats import TileStore
from repro_torch.runtime.faults import FaultPlan, FaultSpec
from repro_torch.serve.graph_service import GraphService
from repro_torch.serve.http import (BadRequest, HttpFrontend, decode_array,
                                    encode_array, parse_query_body)

SS = 200
NV = 220


def _make_store(nv=NV, ne=1400, tile_size=96, seed=7):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    key = src * nv + dst
    _, i = np.unique(key, return_index=True)
    root = tempfile.mkdtemp(prefix="torch_serve_http_store_")
    spe.preprocess_arrays(src[i], dst[i], None, nv, TileStore(root),
                          tile_size)
    store = TileStore(root)
    store.load_meta()
    return store


#: lazily-built singletons shared between pytest fixtures and the
#: hypothesis properties (the shim's @given cannot inject fixtures)
_LAZY: dict = {}


def _store_singleton():
    if "store" not in _LAZY:
        _LAZY["store"] = _make_store()
    return _LAZY["store"]


@pytest.fixture(scope="module")
def store():
    return _store_singleton()


def _schema_frontend():
    """An HTTP frontend over an un-started service: validation and
    ticket bookkeeping run for real, nothing executes (schema tests
    don't need results)."""
    if "fe" not in _LAZY:
        svc = GraphService(_store_singleton(), _cfg(), q_slots=2,
                           max_wait_s=0.01)
        _LAZY["fe"] = HttpFrontend(svc).start()
    return _LAZY["fe"]


def _cfg(**kw):
    return EngineConfig(num_servers=2, max_supersteps=SS, device="cpu", **kw)


# -- tiny urllib client ------------------------------------------------------

def _post(base, body, timeout=30):
    """POST /v1/query; returns (status, decoded json)."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + "/v1/query", data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path, timeout=30):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_with_headers(base, path, timeout=30):
    """GET; returns (status, Retry-After header or None, decoded json)."""
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, r.headers.get("Retry-After"), json.loads(
                r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def _poll(base, rid, timeout=120):
    """Poll GET /v1/query/<rid> until the ticket is terminal."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, j = _get(base, f"/v1/query/{rid}")
        assert code == 200, (code, j)
        if j["status"] in ("done", "timeout", "failed"):
            return j
        time.sleep(0.05)
    raise AssertionError(f"rid {rid} never finished")


def _spawn_serve(store, *extra):
    """Start the port's launch.graph --serve-http on the CPU over the
    given store; returns (process, base_url)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath("src")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.graph", "--serve-http",
         "--device", "cpu", "--port", "0", "--store", store.root, "--reuse",
         "--servers", "2", "--supersteps", str(SS),
         "--max-wait-ms", "10", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    port = None
    for line in p.stdout:
        # the listener is bound before this line prints, so it is safe
        # to talk to the server as soon as the port is known
        if line.startswith("serving http on"):
            port = int(line.rsplit(":", 1)[1])
            break
    assert port is not None, "server never printed its port"
    return p, f"http://127.0.0.1:{port}"


# -- end-to-end subprocess harness ------------------------------------------

def test_e2e_http_results_byte_identical(store):
    """HTTP-served results == direct GraphService.submit == clean run(),
    byte for byte, driven by threaded urllib clients against a real
    --serve-http subprocess of the port."""
    work = [("ppr", 3), ("msbfs", 11), ("landmarks", 9), ("ppr", 77),
            ("msbfs", 42), ("landmarks", 130)]
    p, base = _spawn_serve(store, "--result-cache", "32",
                           "--drain-linger-ms", "4000")
    results = {}
    errors = []

    def client(i, app, seed):
        try:
            code, t = _post(base, dict(app=app, seed=seed,
                                       tenant=f"t{i % 2}"))
            assert code == 200, (code, t)
            assert (t["app"], t["seed"]) == (app, seed)
            results[i] = _poll(base, t["rid"])
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i, app, seed))
                   for i, (app, seed) in enumerate(work)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == len(work)

        # terminate cleanly before comparing (frees the store for reuse)
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=120) == 0
        assert "drained" in out

        svc = GraphService(store, _cfg(), q_slots=3, max_wait_s=0.01,
                           max_supersteps=SS)
        svc.start()
        direct = [svc.submit(app, seed) for app, seed in work]
        for t in direct:
            assert t.wait(120), t
        svc.request_drain()
        svc.join(120)

        for i, (app, seed) in enumerate(work):
            served = results[i]
            assert served["status"] == "done", served
            via_http = decode_array(served["result"])
            # 1) HTTP == direct submit, byte for byte
            assert via_http.tobytes() == direct[i].result.tobytes()
            # 2) HTTP == clean offline run, byte for byte
            eng = OutOfCoreEngine(TileStore(store.root), _cfg())
            ref = eng.run(APPS[app]().with_queries((seed,)))
            assert via_http.dtype == ref.values.dtype
            assert via_http.tobytes() == np.ascontiguousarray(
                ref.values[:, 0]).tobytes(), (app, seed)
            assert served["supersteps"] == ref.per_query_supersteps[0]
            assert served["total_ms"] >= served["service_ms"] >= 0
    finally:
        if p.poll() is None:  # pragma: no cover - cleanup on failure
            p.kill()


def test_e2e_sigterm_mid_load(store):
    """SIGTERM a loaded server: in-flight queries finish, new submits
    get 503, the drain invariant holds, exit code 0."""
    p, base = _spawn_serve(store, "--drain-linger-ms", "6000")
    try:
        rng = np.random.default_rng(0)
        rids = []
        for i in range(6):
            code, t = _post(base, dict(app="msbfs",
                                       seed=int(rng.integers(NV))))
            assert code == 200
            rids.append(t["rid"])
        # wait until at least one query is actually running
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            code, j = _get(base, f"/v1/query/{rids[0]}")
            if j["status"] != "queued":
                break
            time.sleep(0.02)
        p.send_signal(signal.SIGTERM)
        # new submits must be refused with 503 during the drain window
        saw_503 = False
        for _ in range(200):
            try:
                code, j = _post(base, dict(app="msbfs", seed=1), timeout=5)
            except (urllib.error.URLError, ConnectionError, OSError):
                break              # linger expired — server went away
            if code == 503:
                saw_503 = True
                break
            assert code == 200     # raced the drain latch: accepted
            rids.append(j["rid"])
            time.sleep(0.02)
        assert saw_503, "no submit observed the 503 drain refusal"
        # every accepted query resolves during the linger window
        statuses = [_poll(base, rid, timeout=60)["status"] for rid in rids]
        assert all(s in ("done", "timeout", "failed") for s in statuses)
        assert any(s == "done" for s in statuses)
        # stats invariant at drain: submitted == done+timeout+failed+refused
        code, snap = _get(base, "/v1/stats")
        assert code == 200
        s = snap["stats"]
        assert s["submitted"] == (s["done"] + s["timeout"] + s["failed"]
                                  + s["refused"]), s
        assert s["refused"] >= 1
        out = p.stdout.read()
        assert p.wait(timeout=120) == 0
        assert "drained" in out
    finally:
        if p.poll() is None:  # pragma: no cover - cleanup on failure
            p.kill()


# -- request/response schema properties --------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _close_lazy_frontend():
    yield
    fe = _LAZY.pop("fe", None)
    if fe is not None:
        fe.close()


@given(st.binary(min_size=0, max_size=300))
@settings(max_examples=30, deadline=None)
def test_arbitrary_bodies_never_crash_the_handler(raw):
    """Any byte soup POSTed to /v1/query yields a structured 4xx and the
    server keeps answering."""
    frontend = _schema_frontend()
    code, j = _post(frontend.address, raw)
    assert 400 <= code < 500, (code, j)
    assert "error" in j
    assert _get(frontend.address, "/healthz")[0] == 200


@given(st.integers(-(10 ** 12), 10 ** 12),
       st.sampled_from(["ppr", "msbfs", "landmarks", "pagerank", "",
                        "PPR", 7]),
       st.sampled_from([None, 250.0, -1, 0, float("1e18"), "soon"]))
@settings(max_examples=40, deadline=None)
def test_schema_validation_matches_submit_contract(seed, app, deadline_ms):
    """POST /v1/query accepts exactly the bodies the service contract
    allows: servable app, integer seed inside [0, V), positive bounded
    deadline — everything else is a structured 4xx, never a handler
    crash."""
    body = dict(app=app, seed=seed)
    if deadline_ms is not None:
        body["deadline_ms"] = deadline_ms
    valid = (app in ("ppr", "msbfs", "landmarks")
             and 0 <= seed < NV
             and (deadline_ms is None
                  or (isinstance(deadline_ms, (int, float))
                      and 0 < deadline_ms <= 86_400_000)))
    code, j = _post(_schema_frontend().address, body)
    if valid:
        assert code == 200, (body, j)
        assert (j["app"], j["seed"]) == (app, seed)
    else:
        assert 400 <= code < 500, (body, code, j)
        assert "error" in j


def test_valid_request_roundtrips_ticket_fields():
    """Ticket fields survive POST -> GET exactly (rid, app, seed,
    tenant, status, cache_hit)."""
    frontend = _schema_frontend()
    code, t = _post(frontend.address,
                    dict(app="msbfs", seed=17, tenant="acme",
                         deadline_ms=60_000, ignored_extra="ok"))
    assert code == 200
    code, back = _get(frontend.address, f"/v1/query/{t['rid']}")
    assert code == 200
    for k in ("rid", "app", "seed", "tenant", "status", "cache_hit"):
        assert back[k] == t[k], k
    assert back["tenant"] == "acme"
    assert back["status"] == "queued"
    assert back["cache_hit"] is False


#: every malformed POST body of the reference's structured-error test
BAD_BODIES = [
    b"not json at all",
    json.dumps([1, 2, 3]).encode(),                  # non-object
    dict(seed=1),                                    # app missing
    dict(app="pagerank", seed=1),                    # not servable
    dict(app="ppr"),                                 # seed missing
    dict(app="ppr", seed="3"),                       # non-int seed
    dict(app="ppr", seed=True),                      # bool is not int
    dict(app="ppr", seed=-1),                        # negative
    dict(app="ppr", seed=NV),                        # one past the end
    dict(app="ppr", seed=10 ** 18),                  # huge
    dict(app="ppr", seed=1, deadline_ms=0),          # absurd deadline
    dict(app="ppr", seed=1, deadline_ms=-5),
    dict(app="ppr", seed=1, deadline_ms=float("1e18")),
    dict(app="ppr", seed=1, deadline_ms="soon"),
    dict(app="ppr", seed=1, tenant=""),              # bad tenant
    dict(app="ppr", seed=1, tenant="x" * 65),
    dict(app="ppr", seed=1, tenant=7),
]


def test_structured_errors_for_each_field():
    base = _schema_frontend().address
    for body in BAD_BODIES:
        code, j = _post(base, body)
        assert 400 <= code < 500, body
        assert "error" in j, body
    code, j = _get(base, "/v1/query/not-a-rid")
    assert code == 400
    code, j = _get(base, "/v1/query/999999")
    assert code == 404
    code, j = _get(base, "/nope")
    assert code == 404


def test_parse_query_body_unit():
    kw = parse_query_body(
        json.dumps(dict(app="ppr", seed=5, deadline_ms=1500,
                        tenant="t")).encode(), 10)
    assert kw == dict(app="ppr", seed=5, deadline_s=1.5, tenant="t")
    with pytest.raises(BadRequest):
        parse_query_body(b"\xff\xfe", 10)
    with pytest.raises(BadRequest) as e:
        parse_query_body(b"x" * (2 ** 20 + 1), 10)
    assert e.value.status == 413


def test_encode_decode_array_bit_exact():
    rng = np.random.default_rng(3)
    for a in (rng.standard_normal(37).astype(np.float32),
              rng.integers(-(2 ** 60), 2 ** 60, 11),
              np.array([np.inf, -np.inf, np.nan, -0.0])):
        b = decode_array(json.loads(json.dumps(encode_array(a))))
        assert b.dtype == a.dtype and b.shape == a.shape
        assert a.tobytes() == b.tobytes()


# -- http_response fault site -------------------------------------------------

def _served_service(store, fault=None, **kw):
    svc = GraphService(store, _cfg(), q_slots=2, max_wait_s=0.01,
                       max_supersteps=SS, **kw)
    svc.start()
    fe = HttpFrontend(svc, fault=fault).start()
    return svc, fe


def test_dropped_response_retry_same_rid_gets_result(store):
    """site=http_response kind=drop: the first response is lost on the
    wire; service state stays consistent and the client's retry of the
    same rid observes the completed result."""
    plan = FaultPlan(specs=(FaultSpec(site="http_response", kind="drop"),))
    svc, fe = _served_service(store, fault=plan.injector())
    try:
        t = svc.submit("msbfs", 11)     # submit directly: the GET is the
        assert t.wait(120)              # response under test
        before = svc.stats_snapshot()["stats"]
        with pytest.raises((urllib.error.URLError, ConnectionError,
                            OSError)):
            urllib.request.urlopen(
                fe.address + f"/v1/query/{t.rid}", timeout=10).read()
        assert fe.counters()["dropped_responses"] == 1
        # retry, same rid: the completed result comes back intact
        code, j = _get(fe.address, f"/v1/query/{t.rid}")
        assert code == 200 and j["status"] == "done"
        assert np.array_equal(decode_array(j["result"]), t.result)
        after = svc.stats_snapshot()["stats"]
        assert before == after          # the drop mutated nothing
    finally:
        svc.request_drain()
        svc.join(120)
        fe.close()


def test_delayed_response_arrives_late_but_intact(store):
    plan = FaultPlan(specs=(FaultSpec(site="http_response", kind="delay",
                                      delay_seconds=0.3),))
    svc, fe = _served_service(store, fault=plan.injector())
    try:
        t = svc.submit("msbfs", 42)
        assert t.wait(120)
        t0 = time.perf_counter()
        code, j = _get(fe.address, f"/v1/query/{t.rid}")
        assert time.perf_counter() - t0 >= 0.3
        assert code == 200 and j["status"] == "done"
        assert np.array_equal(decode_array(j["result"]), t.result)
    finally:
        svc.request_drain()
        svc.join(120)
        fe.close()


def test_stats_and_healthz_lifecycle(store):
    svc, fe = _served_service(store, result_cache=8,
                              tenants={"a": 2.0, "b": 1.0})
    try:
        assert _get(fe.address, "/healthz") == (200, dict(status="ok"))
        code, t = _post(fe.address, dict(app="ppr", seed=3, tenant="a"))
        assert code == 200
        _poll(fe.address, t["rid"])
        code, snap = _get(fe.address, "/v1/stats")
        assert code == 200
        assert snap["stats"]["done"] == 1
        assert snap["tenants"]["a"]["submitted"] == 1
        assert snap["cache"]["misses"] == 1
        assert snap["http"]["requests"] >= 2
        assert snap["latency"]["count"] == 1
    finally:
        svc.request_drain()
        svc.join(120)
    # after drain: healthz flips to 503, POST refuses with Retry-After,
    # GET of the finished rid still answers
    code, retry, j = _get_with_headers(fe.address, "/healthz")
    assert (code, retry) == (503, "1")
    code, j = _post(fe.address, dict(app="ppr", seed=4))
    assert code == 503
    code, j = _get(fe.address, f"/v1/query/{t['rid']}")
    assert code == 200 and j["status"] == "done"
    fe.close()


# -- parity with the reference's wire format and validation ------------------

def _parse_both(raw, nv=NV):
    """(kind, value) of each package's parse_query_body on ``raw``: the
    submit kwargs, or the BadRequest's (status, message)."""
    out = []
    for parse, bad in ((parse_query_body, BadRequest),
                       (jhttp.parse_query_body, jhttp.BadRequest)):
        try:
            out.append(("ok", parse(raw, nv)))
        except bad as e:
            out.append(("bad", (e.status, str(e))))
    return out


@given(st.binary(min_size=0, max_size=300))
@settings(max_examples=60, deadline=None)
def test_parse_query_body_equals_reference_on_bytes(raw):
    port, ref = _parse_both(raw)
    assert port == ref


@given(st.sampled_from(["ppr", "msbfs", "landmarks", "pagerank", "", 7,
                        None]),
       st.sampled_from([0, 5, NV - 1, NV, -1, 10 ** 18, True, "3", 2.0,
                        None]),
       st.sampled_from([None, 1, 250.0, 1e-3, 0, -5, 86_400_000,
                        86_400_001, float("inf"), float("nan"), "soon",
                        False]),
       st.sampled_from([None, "t", "acme", "", "x" * 64, "x" * 65, 7,
                        "tab\there"]))
@settings(max_examples=120, deadline=None)
def test_parse_query_body_equals_reference_on_bodies(app, seed, deadline_ms,
                                                     tenant):
    """Both packages accept the same JSON bodies with the same kwargs and
    refuse the others with the same status and message."""
    body = {k: v for k, v in (("app", app), ("seed", seed),
                              ("deadline_ms", deadline_ms),
                              ("tenant", tenant)) if v is not None}
    port, ref = _parse_both(json.dumps(body).encode())
    assert port == ref, body


@given(st.sampled_from(["float32", "float64", "int32", "int64", "uint8",
                        "bool"]),
       st.integers(0, 40), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=40, deadline=None)
def test_encode_decode_array_equal_reference(dtype, n, seed):
    """The same wire dict for the same array, and each package decodes
    the other's bit for bit."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n) * 1e6).astype(dtype)
    if dtype.startswith("float") and n >= 4:
        a[:4] = [np.inf, -np.inf, np.nan, -0.0]
    wire = json.loads(json.dumps(encode_array(a)))
    assert wire == json.loads(json.dumps(jhttp.encode_array(a)))
    for b in (decode_array(wire), jhttp.decode_array(wire)):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert b.tobytes() == a.tobytes()


def test_error_statuses_equal_reference(store):
    """The two frontends, each over an un-started service on one store,
    answer the same requests with the same statuses and JSON bodies —
    accepted tickets included — and, once drained, the same 503s with
    Retry-After."""
    requests = [("POST", b) for b in BAD_BODIES] + [
        ("POST", dict(app="msbfs", seed=17, tenant="acme",
                      deadline_ms=60_000)),
        ("POST", dict(app="ppr", seed=3)),
        ("GET", "/v1/query/0"), ("GET", "/v1/query/1"),
        ("GET", "/v1/query/not-a-rid"), ("GET", "/v1/query/999999"),
        ("GET", "/nope"), ("GET", "/healthz")]
    fes = [HttpFrontend(GraphService(store, _cfg(), q_slots=2)).start(),
           jhttp.HttpFrontend(JService(JTileStore(store.root),
                                       JConfig(num_servers=2),
                                       q_slots=2)).start()]
    try:
        def answers(fe):
            out = []
            for method, what in requests:
                out.append(_post(fe.address, what) if method == "POST"
                           else _get(fe.address, what))
            fe.service.request_drain()
            out.append(_get_with_headers(fe.address, "/healthz"))
            out.append(_post(fe.address, dict(app="ppr", seed=4)))
            return out

        port, ref = (answers(fe) for fe in fes)
        assert port == ref
        assert port[-2][:2] == (503, "1") and port[-1][0] == 503
        # the reference counts an error after writing its body, so a client
        # can hold its last answer before the handler has counted it: wait
        # until each frontend has counted every error it answered
        for fe, out in zip(fes, (port, ref)):
            n_err = sum(1 for a in out if a[0] >= 400)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                c = fe.counters()
                if c.get("errors_4xx", 0) + c.get("errors_5xx", 0) == n_err:
                    break
                time.sleep(0.01)
        assert fes[0].counters() == fes[1].counters()
    finally:
        for fe in fes:
            fe.close()
