"""The port's online graph-query service (``repro_torch.serve.graph_service``)
against itself and the JAX package's.

The counterparts of ``tests/test_serve_graph.py``'s graph-service tests:
served results equal fresh runs bit for bit, deadlines drain to timeout
tickets, SIGTERM drains gracefully (the in-process flag drill and a real
``repro_torch.launch.graph --serve --device cpu`` subprocess),
checkpoint-drain and resume keep in-flight queries alive across a
restart, unbatched apps are refused, and the latency split.  Then parity
with the reference (``JAX_PLATFORMS=cpu``, its default ``seg_impl="jnp"``):
one script of submits, fully queued before ``start()``, through both
services — MultiSourceBFS and LandmarkDistances ``array_equal`` with equal
supersteps, PPR within ``rtol=1e-5, atol=1e-6``, both converged.  PPR's
retirement superstep is not compared across the packages: its
``update_tol`` lies below float32 resolution, so a column retires when its
float32 iteration reaches a fixed point, which depends on the order of
summation (on this store, seeds converging after 75-92 supersteps differ
by up to 10; ROADMAP.md C) — and a service the reference drained with ``drain_mode="checkpoint"``
resumed by the port with the same live queries and lineage.  The port runs
on ``device="cpu"``, where the kernels' plain versions run.
"""
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JConfig
from repro.graphio.formats import TileStore as JTileStore
from repro.serve.graph_service import GraphService as JService
from repro_torch.core.apps import APPS
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio import spe
from repro_torch.graphio.formats import TileStore
from repro_torch.launch import graph as tgraph
from repro_torch.serve.graph_service import (GraphService, QueryTicket,
                                             bind_device)
from repro_torch.serve.http import decode_array

SS = 120
PR_TOL = dict(rtol=1e-5, atol=1e-6)


def _make_store(nv=220, ne=1400, tile_size=96, seed=7):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    key = src * nv + dst
    _, i = np.unique(key, return_index=True)
    root = tempfile.mkdtemp(prefix="torch_serve_store_")
    spe.preprocess_arrays(src[i], dst[i], None, nv, TileStore(root),
                          tile_size)
    store = TileStore(root)
    store.load_meta()
    return store


@pytest.fixture(scope="module")
def store():
    return _make_store()


def _cfg(**kw):
    return EngineConfig(num_servers=2, max_supersteps=SS, device="cpu", **kw)


def _fresh(store, app, seed):
    eng = OutOfCoreEngine(TileStore(store.root), _cfg())
    return eng.run(APPS[app]().with_queries((seed,)))


def _drain_and_join(svc, timeout=120):
    svc.request_drain()
    svc.join(timeout)
    assert svc._thread is not None and not svc._thread.is_alive()


def test_service_results_match_fresh_runs(store):
    svc = GraphService(store, _cfg(), q_slots=3, min_fill=2,
                       max_wait_s=0.01, max_supersteps=SS)
    svc.start()
    work = [("ppr", 3), ("msbfs", 11), ("ppr", 77), ("msbfs", 42),
            ("ppr", 105), ("landmarks", 9)]
    tickets = [svc.submit(app, seed) for app, seed in work]
    for t in tickets:
        assert t.wait(120), t
    _drain_and_join(svc)
    assert svc.stats["done"] == len(work)
    assert svc.stats["timeout"] == svc.stats["failed"] == 0
    for t in tickets:
        assert t.status == "done"
        # results leave the engine as host arrays, never torch tensors
        assert type(t.result) is np.ndarray
        ref = _fresh(store, t.app, t.seed)
        # online-served query == fresh batch run, bit for bit
        assert np.array_equal(t.result, ref.values[:, 0]), (t.app, t.seed)
        assert t.supersteps == ref.per_query_supersteps[0]
        assert t.total_s >= t.service_s >= 0
        assert t.queue_wait_s >= 0
    s = svc.latency_summary()
    assert s["count"] == len(work)
    assert s["p99_ms"] >= s["p50_ms"] > 0


def test_deadline_drains_to_timeout(store):
    svc = GraphService(store, _cfg(), q_slots=2, max_wait_s=0.01,
                       max_supersteps=SS)
    svc.start()
    slow = svc.submit("ppr", 3, deadline_s=0.0)      # overdue on arrival
    ok = svc.submit("msbfs", 11)
    assert slow.wait(120) and ok.wait(120)
    _drain_and_join(svc)
    assert slow.status == "timeout"
    assert slow.supersteps == -1          # drained, never converged
    assert slow.result is not None        # partial column still delivered
    assert ok.status == "done"
    assert svc.stats["timeout"] == 1 and svc.stats["done"] == 1


def test_sigterm_flag_drains_in_flight_work(store):
    """The in-process half of the SIGTERM drill: latch the guard flag the
    signal handler would set; the loop must stop admitting and finish
    in-flight queries before returning."""
    svc = GraphService(store, _cfg(), q_slots=2, max_wait_s=0.01,
                       max_supersteps=SS)
    svc.start()
    tickets = [svc.submit("ppr", s) for s in (3, 77)]
    while svc.stats["supersteps"] < 1:     # in-flight for real
        time.sleep(0.005)
    svc.guard.triggered = True             # what SIGTERM does
    svc.join(120)
    assert not svc._thread.is_alive()
    assert all(t.status == "done" for t in tickets)
    with pytest.raises(RuntimeError):
        svc.submit("ppr", 9)               # drained services reject work


def test_sigterm_subprocess_drill():
    """The real drill: SIGTERM a live ``repro_torch.launch.graph --serve``
    process on the CPU — it must drain gracefully and exit 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath("src")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.graph", "--serve",
         "--device", "cpu", "--vertices", "300", "--edges", "1500",
         "--tile-size", "128", "--servers", "1", "--serve-requests", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    try:
        for line in p.stdout:
            if "serving" in line:
                break
        assert "device=cpu" in line
        time.sleep(0.3)
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=120) == 0
        assert "drained" in out
    finally:
        if p.poll() is None:      # pragma: no cover - cleanup on failure
            p.kill()


def _serve_http_cli(store, *extra):
    """The port's ``--serve-http`` CLI on the CPU over ``store``; returns
    (process, base URL) once it printed its port."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.graph", "--serve-http",
         "--device", "cpu", "--port", "0", "--store", store.root, "--reuse",
         "--servers", "2", "--supersteps", str(SS), "--max-wait-ms", "10",
         *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    for line in p.stdout:
        if line.startswith("serving http on"):
            return p, f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
    raise AssertionError("the server never printed its port")


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=30) as r:
        return json.loads(r.read())


def test_cli_sigterm_checkpoint_drill_resumes(store, tmp_path):
    """The CLI's SIGTERM drill with ``--drain-mode checkpoint``: two PPR
    queries in flight are checkpointed and the process exits 0; a
    ``--resume`` process finishes them to the fresh-run answers."""
    ck = str(tmp_path / "ck")
    p, base = _serve_http_cli(store, "--drain-mode", "checkpoint",
                              "--checkpoint-dir", ck,
                              "--drain-linger-ms", "0")
    try:
        for seed in (3, 77):
            _http(base + "/v1/query", dict(app="ppr", seed=seed))
        deadline = time.monotonic() + 60
        while _http(base + "/v1/stats")["stats"]["supersteps"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=120) == 0, out
        assert "drained: 0 done, 0 timeout, 2 failed" in out, out
    finally:
        if p.poll() is None:      # pragma: no cover - cleanup on failure
            p.kill()
    p, base = _serve_http_cli(store, "--checkpoint-dir", ck, "--resume")
    try:
        got = {}
        deadline = time.monotonic() + 120
        while len(got) < 2:
            assert time.monotonic() < deadline
            for rid in (0, 1):
                t = _http(f"{base}/v1/query/{rid}")
                if t["status"] == "done":
                    got[t["seed"]] = t
            time.sleep(0.05)
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=120) == 0, out
        assert "drained: 2 done" in out, out
    finally:
        if p.poll() is None:      # pragma: no cover - cleanup on failure
            p.kill()
    assert sorted(got) == [3, 77]
    for seed, t in got.items():
        ref = _fresh(store, "ppr", seed)
        assert decode_array(t["result"]).tobytes() == np.ascontiguousarray(
            ref.values[:, 0]).tobytes()
        assert t["supersteps"] == ref.per_query_supersteps[0]


def test_checkpoint_drain_and_resume(store, tmp_path):
    """drain_mode='checkpoint': SIGTERM-style drain checkpoints live
    sessions with their query lineage; a resumed service re-registers the
    in-flight queries and finishes them to the fresh-run answers."""
    ck = str(tmp_path / "svc_ck")
    cfg = _cfg(checkpoint_dir=ck)
    svc = GraphService(store, cfg, q_slots=2, max_wait_s=0.01,
                       max_supersteps=SS, drain_mode="checkpoint")
    svc.start()
    seeds = (3, 77)
    tickets = [svc.submit("ppr", s) for s in seeds]
    while svc.stats["supersteps"] < 2:      # mid-flight, not converged
        time.sleep(0.005)
    svc.request_drain()
    svc.join(120)
    assert all(t.status == "failed" for t in tickets)   # not resolved here
    assert os.path.isdir(os.path.join(ck, "ppr"))

    svc2 = GraphService(store, cfg, q_slots=2, max_wait_s=0.01,
                        max_supersteps=SS, resume=True)
    # the resumed service re-registered the live columns from the
    # manifest lineage before serving anything new
    resumed = {t.seed: t for app in svc2._live
               for t in svc2._live[app].values()}
    assert set(resumed) == set(seeds)
    svc2.start()
    for t in resumed.values():
        assert t.wait(120), t
    _drain_and_join(svc2)
    for s in seeds:
        t = resumed[s]
        assert t.status == "done"
        ref = _fresh(store, "ppr", s)
        assert np.array_equal(t.result, ref.values[:, 0]), s
        assert t.supersteps == ref.per_query_supersteps[0]


def test_submit_rejects_unbatched_app(store):
    svc = GraphService(store, _cfg())
    with pytest.raises(ValueError):
        svc.submit("pagerank", 0)


def test_ticket_latency_components():
    t = QueryTicket(rid=0, app="ppr", seed=1, submitted_s=1.0,
                    admitted_s=3.0, finished_s=7.5)
    assert t.queue_wait_s == 2.0
    assert t.service_s == 4.5
    assert t.total_s == 6.5


# -- the port's own: the device and the engines' lifetime --------------------


def test_service_pins_its_device_and_refuses_a_missing_card(store):
    """The engine config's device is pinned when the service is built, so
    a service asked for CUDA on a host without a card raises then — not
    at its first request — and so does the CLI."""
    assert bind_device("cpu") == "cpu"
    assert GraphService(store, _cfg()).cfg.device == "cpu"
    if torch.cuda.is_available():
        assert bind_device("cuda") == f"cuda:{torch.cuda.current_device()}"
        return
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphService(store, EngineConfig(num_servers=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tgraph.main(["--serve", "--store", store.root, "--reuse",
                     "--serve-requests", "0"])


def test_engines_outlive_sessions(store):
    """One engine per app for the service's life: a second session of an
    app runs on the engine of the first."""
    svc = GraphService(store, _cfg(), q_slots=2, max_wait_s=0.01,
                       max_supersteps=SS)
    svc.start()
    try:
        first = svc.submit("msbfs", 11)
        assert first.wait(120) and first.status == "done"
        while "msbfs" in svc._sessions:    # the session closes after its
            time.sleep(0.005)              # last retirement
        eng = svc._engines["msbfs"]
        second = svc.submit("msbfs", 42)
        assert second.wait(120) and second.status == "done"
    finally:
        _drain_and_join(svc)
    assert svc.stats["sessions_opened"] == 2
    assert svc._engines["msbfs"] is eng
    ref = _fresh(store, "msbfs", 42)
    assert np.array_equal(second.result, ref.values[:, 0])


# -- parity with the reference service ---------------------------------------

#: one script of submits: (app, seed, tenant), both tenants in every app
SCRIPT = [("msbfs", 11, "a"), ("landmarks", 9, "b"), ("ppr", 3, "a"),
          ("msbfs", 42, "b"), ("landmarks", 130, "a"), ("ppr", 77, "b"),
          ("msbfs", 0, "a"), ("landmarks", 57, "a"), ("ppr", 105, "a"),
          ("msbfs", 199, "b"), ("landmarks", 9, "a"), ("msbfs", 11, "b")]
SERVE_KW = dict(q_slots=3, min_fill=2, max_wait_s=0.01, max_supersteps=SS,
                tenants={"a": 2.0, "b": 1.0})


def _serve_script(svc):
    """Queue SCRIPT before the loop starts, serve it, drain; returns the
    tickets and the service's counters."""
    tickets = [svc.submit(app, seed, tenant=tenant)
               for app, seed, tenant in SCRIPT]
    svc.start()
    for t in tickets:
        assert t.wait(120), t
    svc.request_drain()
    svc.join(120)
    assert not svc._thread.is_alive()
    return tickets, svc.stats_snapshot()


@pytest.fixture(scope="module")
def served(store):
    """The script through the reference service and the port's."""
    ref = _serve_script(JService(JTileStore(store.root),
                                 JConfig(num_servers=2, max_supersteps=SS),
                                 **SERVE_KW))
    port = _serve_script(GraphService(TileStore(store.root), _cfg(),
                                      **SERVE_KW))
    return ref, port


@pytest.mark.parametrize("app", ["msbfs", "landmarks", "ppr"])
def test_service_matches_reference(served, app):
    (jt, jsnap), (tt, tsnap) = served
    for j, t in zip(jt, tt):
        assert (j.rid, j.app, j.seed, j.tenant, j.status) == (
            t.rid, t.app, t.seed, t.tenant, t.status)
        if t.app != app:
            continue
        assert t.status == "done"
        if app == "ppr":
            np.testing.assert_allclose(t.result, j.result, **PR_TOL)
            assert t.supersteps > 0 and j.supersteps > 0
        else:
            assert np.array_equal(t.result, j.result), (app, t.seed)
            assert t.supersteps == j.supersteps
    assert tsnap["tenants"] == jsnap["tenants"]
    assert tsnap["fingerprint"] == jsnap["fingerprint"]
    for key in ("submitted", "done", "timeout", "failed", "refused"):
        assert tsnap["stats"][key] == jsnap["stats"][key], key


@pytest.mark.parametrize("app", ["msbfs", "ppr"])
def test_reference_checkpoint_drain_resumes_in_port(store, tmp_path, app):
    """A service the reference drained with drain_mode='checkpoint' after
    two supersteps resumes in the port with the same live queries and
    lineage, and finishes them to the port's fresh-run answers (PPR to
    its tolerance, its retirement superstep not compared: the first two
    supersteps summed in the reference's order)."""
    ck = str(tmp_path / "ck")
    seeds = (3, 77)
    jsvc = JService(JTileStore(store.root),
                    JConfig(num_servers=2, max_supersteps=SS,
                            checkpoint_dir=ck),
                    q_slots=2, max_supersteps=SS, drain_mode="checkpoint")
    for s in seeds:
        jsvc.submit(app, s)
    for _ in range(2):                     # open + step, then step: two
        assert not jsvc._tick()            # supersteps, nothing converged
    assert jsvc.stats["supersteps"] == 2
    jsvc.request_drain()
    jsvc.serve()                           # checkpoints the live session
    peek = jsvc._engines[app].ckpt.peek_manifest()[1]

    svc = GraphService(TileStore(store.root), _cfg(checkpoint_dir=ck),
                       q_slots=2, max_supersteps=SS, resume=True)
    sess = svc._sessions[app]
    assert list(sess.active_queries) == [int(g) for g in peek["active_q"]]
    assert sess.superstep == 2
    resumed = {t.seed: t for t in svc._live[app].values()}
    assert sorted(resumed) == sorted(
        int(s) for s in peek["queries"].values())
    assert sorted(resumed) == sorted(seeds)
    svc.start()
    for t in resumed.values():
        assert t.wait(120), t
    _drain_and_join(svc)
    for s in seeds:
        t, ref = resumed[s], _fresh(store, app, s)
        assert t.status == "done"
        if app == "ppr":
            np.testing.assert_allclose(t.result, ref.values[:, 0], **PR_TOL)
        else:
            assert np.array_equal(t.result, ref.values[:, 0]), s
            assert t.supersteps == ref.per_query_supersteps[0]


# -- the CLI's scripted workload on a reused store ---------------------------


def test_cli_scripted_workload_on_a_reused_store(store, capsys):
    """``--serve --reuse --store`` with the default ``--vertices`` (100,000,
    past this store's 220): the port's feeder draws its seeds below the
    store's vertex count, serves the workload and drains."""
    svc = tgraph.main(["--serve", "--device", "cpu", "--store", store.root,
                       "--reuse", "--servers", "2", "--serve-requests", "4",
                       "--serve-apps", "msbfs,landmarks", "--supersteps",
                       str(SS)])
    assert svc.stats["done"] == 4 and svc.stats["sessions_opened"] >= 1
    assert all(0 <= t.seed < svc.num_vertices for t in svc.completed)
    assert "drained: 4 done" in capsys.readouterr().out


def test_reference_feeder_dies_on_a_reused_store(store):
    """The reference's feeder draws seeds below ``--vertices``, not the
    store's vertex count (``repro/launch/graph.py:118``): on a reused
    store of fewer vertices its first submit raises ValueError in the
    feeder thread, nothing ever requests the drain, and the process
    serves on until a signal (ROADMAP.md C)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.graph", "--serve", "--store",
         store.root, "--reuse", "--servers", "2", "--serve-requests", "4",
         "--serve-apps", "msbfs,landmarks"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    try:
        lines = []
        for line in p.stdout:
            lines.append(line)
            if line.startswith("ValueError: seed"):
                break
        assert lines and lines[-1].startswith("ValueError: seed"), lines
        time.sleep(1.0)
        assert p.poll() is None           # still serving, nothing drained
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=60) == 0    # the SIGTERM drain still works
        assert "drained: 0 done" in out
    finally:
        if p.poll() is None:      # pragma: no cover - cleanup on failure
            p.kill()
