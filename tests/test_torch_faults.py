"""Fault injection and crash-consistent superstep checkpoints in the port
(DESIGN.md §12), on the CPU.

The acceptance property, as tests/test_faults.py holds it for the
reference: **crash anywhere, resume, and get byte for byte the answers of
the uninterrupted run** — all eight apps, single and batched, in memory
and out of core, in every engine mode, after a crash or a preemption at
any named site, at the saved server count or another, and in spawned
clusters that restart or shrink over shared memory and TCP.  The spec
parser, the once-markers (shared with the reference's), torn writes, the
transport wrapper and the elastic remap are held here too; the checkpoint
files themselves, and the cross-loads between the two packages, are in
tests/test_torch_checkpoint.py.  The port runs on ``device="cpu"`` (the
kernels' plain versions).  The JAX package is imported inside tests only.
"""
import dataclasses
import glob
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # deterministic fallback, see _hypothesis_compat
    from _hypothesis_compat import given, settings, strategies as st

from repro_torch.core import apps as tapps
from repro_torch.core.checkpoint import GraphCheckpointer
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio import spe
from repro_torch.graphio.formats import TileStore
from repro_torch.launch import graph as tgraph
from repro_torch.launch.cluster import (ClusterConfig, ClusterFailure,
                                        run_cluster)
from repro_torch.runtime import faults
from repro_torch.runtime.elastic import handoff_plan, remap_assignment
from repro_torch.runtime.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.runtime.ft import (FaultTolerantLoop, Preempted,
                                    PreemptionGuard)

SS = 12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = ("pagerank", "wcc", "bfs", "indegree", "ppr", "msbfs", "sssp",
        "landmarks")
WEIGHTED = ("sssp", "landmarks")


def _make_store(weighted, seed=7, nv=220, ne=1400, tile_size=96):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    _, i = np.unique(src * nv + dst, return_index=True)
    src, dst = src[i], dst[i]
    val = (rng.uniform(0.1, 10.0, len(src)).astype(np.float32)
           if weighted else None)
    root = tempfile.mkdtemp(prefix=f"tfaults_store_{int(weighted)}_")
    spe.preprocess_arrays(src, dst, val, nv, TileStore(root), tile_size)
    return root


@pytest.fixture(scope="module")
def stores():
    """(unweighted root, weighted root) shared by every test here."""
    return _make_store(False), _make_store(True)


def _prog(app):
    return {"pagerank": tapps.PageRank, "wcc": tapps.WCC,
            "bfs": lambda: tapps.BFS(source=0), "indegree": tapps.InDegree,
            "ppr": lambda: tapps.PersonalizedPageRank(seeds=(1, 7, 50)),
            "msbfs": lambda: tapps.MultiSourceBFS(sources=(2, 11, 60)),
            "sssp": lambda: tapps.SSSP(source=0),
            "landmarks": lambda: tapps.LandmarkDistances(
                landmarks=(0, 9, 33))}[app]()


def _root(stores, app):
    return stores[1] if app in WEIGHTED else stores[0]


def _run(root, prog, *, n=2, **cfg_kw):
    eng = OutOfCoreEngine(TileStore(root), EngineConfig(
        device="cpu", num_servers=n, max_supersteps=SS, **cfg_kw))
    return eng.run(prog)


def _assert_same_run(got, want):
    assert np.array_equal(got.values, want.values)
    assert got.supersteps == want.supersteps
    assert got.converged == want.converged
    if want.per_query_supersteps is not None:
        assert np.array_equal(got.per_query_supersteps,
                              want.per_query_supersteps)


def _crash_then_resume(root, app, plan, ck, catch=InjectedFault, **kw):
    """Run ``app`` with checkpoints under ``plan`` (which must fire), then
    resume from ``ck``; returns the resumed RunResult."""
    with pytest.raises(catch):
        _run(root, _prog(app), checkpoint_dir=ck, fault_plan=plan, **kw)
    kw.pop("checkpoint_every", None)
    kw.pop("preemptible", None)
    return _run(root, _prog(app), checkpoint_dir=ck, resume=True, **kw)


# ---------------------------------------------------------------------------
# FaultSpec / FaultInjector
# ---------------------------------------------------------------------------

def test_parse_spec_roundtrip():
    from repro.runtime import faults as jfaults

    s = faults.parse_spec("rank=1, superstep=2, site=superstep, kind=sigkill")
    assert s == FaultSpec(site="superstep", superstep=2, rank=1,
                          kind="sigkill")
    text = "site=ckpt.leaf,kind=torn_write,keep_bytes=3,then=kill,once=false"
    s = faults.parse_spec(text)
    assert s.keep_bytes == 3 and s.then == "kill" and not s.once
    assert dataclasses.asdict(s) == dataclasses.asdict(
        jfaults.parse_spec(text))
    assert s.spec_id() == jfaults.parse_spec(text).spec_id()
    with pytest.raises(ValueError, match="needs site"):
        faults.parse_spec("kind=raise")
    with pytest.raises(ValueError, match="unknown --inject key"):
        faults.parse_spec("site=x,bogus=1")
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.parse_spec("site=x,kind=meteor")
    assert faults.parse_plan([]) is None
    plan = faults.parse_plan(["site=a", "site=b,superstep=4"], marker_dir="m")
    assert len(plan.specs) == 2 and plan.marker_dir == "m"


def test_injector_matching_and_once():
    plan = FaultPlan(specs=(FaultSpec(site="superstep", superstep=3,
                                      rank=1),))
    inj = plan.injector(rank=0)
    inj.check("superstep", 3)           # wrong rank: no fire
    inj = plan.injector(rank=1)
    inj.check("superstep", 2)           # wrong step: no fire
    inj.check("barrier", 3)             # wrong site: no fire
    with pytest.raises(InjectedFault):
        inj.check("superstep", 3)
    inj.check("superstep", 3)           # once=True: second pass is a no-op
    assert inj.fired == [plan.specs[0].spec_id()]
    # rank=None (one process) matches any rank spec
    with pytest.raises(InjectedFault):
        plan.injector().check("superstep", 3)


@pytest.mark.parametrize("first", ["port", "reference"])
def test_once_markers_are_shared_with_the_reference(tmp_path, first):
    """A once-marker claimed by one package is honoured by the other: the
    same spec id names the same file, so a respawn of either kind does not
    re-fire the fault."""
    from repro.runtime import faults as jfaults

    spec = dict(site="ckpt.pre_rename", superstep=2, rank=1)
    port = FaultPlan(specs=(FaultSpec(**spec),), marker_dir=str(tmp_path))
    ref = jfaults.FaultPlan(specs=(jfaults.FaultSpec(**spec),),
                            marker_dir=str(tmp_path))
    a, b = (port, ref) if first == "port" else (ref, port)
    with pytest.raises(RuntimeError, match="injected fault"):
        a.injector(rank=1).check("ckpt.pre_rename", 2)
    b.injector(rank=1).check("ckpt.pre_rename", 2)     # already claimed
    assert [os.path.basename(p) for p in glob.glob(str(tmp_path / "*"))] \
        == ["ckpt-pre_rename_2_1_raise.fired"]


def test_injector_once_marker_survives_restart(tmp_path):
    plan = FaultPlan(specs=(FaultSpec(site="superstep", superstep=2),),
                     marker_dir=str(tmp_path))
    with pytest.raises(InjectedFault):
        plan.injector(rank=0).check("superstep", 2)
    plan.injector(rank=0).check("superstep", 2)   # a fresh process's arm
    assert glob.glob(str(tmp_path) + "/*.fired")


def test_injector_torn_write_and_drop(tmp_path):
    plan = FaultPlan(specs=(
        FaultSpec(site="ckpt.leaf", kind="torn_write", keep_bytes=3),
        FaultSpec(site="transport.send", superstep=5, kind="drop_frame"),
    ))
    inj = plan.injector()
    inj.check("ckpt.leaf", 1)           # torn_write fires through write()
    p = str(tmp_path / "leaf.npy")
    with pytest.raises(InjectedFault, match="torn write"):
        inj.write(p, b"ABCDEFGH", "ckpt.leaf", 1)
    with open(p, "rb") as f:
        assert f.read() == b"ABC"       # the torn prefix really hit disk
    inj.write(p, b"ABCDEFGH", "ckpt.leaf", 2)
    with open(p, "rb") as f:
        assert f.read() == b"ABCDEFGH"
    assert inj.drop("transport.send", 4) is False
    assert inj.drop("transport.send", 5) is True
    assert inj.drop("transport.send", 5) is False   # once


def test_injector_delay_and_preempt_kinds():
    t0 = time.perf_counter()
    FaultPlan(specs=(FaultSpec(site="superstep", superstep=1, kind="delay",
                               delay_seconds=0.05),)).injector().check(
        "superstep", 1)
    assert time.perf_counter() - t0 >= 0.05
    with PreemptionGuard() as g:
        FaultPlan(specs=(FaultSpec(site="barrier", kind="preempt"),)) \
            .injector().check("barrier", 0)
        assert g.triggered


def test_fault_injecting_transport_drop():
    from repro_torch.core.transport import FaultInjectingTransport, _U32

    sent = []

    class Fake:
        rank, n = 0, 2

        def send(self, dst, payload, timeout=None):
            sent.append((dst, payload))

        def recv(self, timeout=0.1):
            return (1, b"pong")

        def close(self):
            sent.append("closed")

    plan = FaultPlan(specs=(
        FaultSpec(site="transport.send", superstep=2, kind="drop_frame"),))
    tr = FaultInjectingTransport(Fake(), plan.injector(rank=0))
    assert (tr.rank, tr.n) == (0, 2)
    tr.send(1, _U32.pack(1) + b"payload")       # seq 1 passes
    tr.send(1, _U32.pack(2) + b"payload")       # seq 2 lost on the wire
    tr.send(1, _U32.pack(2) + b"payload")       # once: passes again
    assert [p[:4] for _, p in sent] == [_U32.pack(1), _U32.pack(2)]
    assert tr.recv() == (1, b"pong")
    tr.close()
    assert sent[-1] == "closed"


def test_fault_injecting_transport_kill(tmp_path):
    """``kind="kill"`` at ``transport.send`` ends the process with 137
    before the frame leaves: nothing reaches the ring."""
    code = (
        "import sys\n"
        "from repro_torch.core import transport as T\n"
        "from repro_torch.runtime.faults import FaultPlan, FaultSpec\n"
        "d = sys.argv[1]\n"
        "T.create_ring_files(d, 2)\n"
        "plan = FaultPlan(specs=(FaultSpec(site='transport.send', "
        "superstep=1, kind='kill'),))\n"
        "tr = T.FaultInjectingTransport(T.RingTransport(0, 2, d), "
        "plan.injector(rank=0))\n"
        "tr.send(1, T._U32.pack(0) + b'first')\n"
        "print('sent', flush=True)\n"
        "tr.send(1, T._U32.pack(1) + b'second')\n"
        "print('survived', flush=True)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 137, proc.stderr
    assert proc.stdout.split() == ["sent"]
    from repro_torch.core import transport as T

    rx = T.RingTransport(1, 2, str(tmp_path))
    try:
        assert rx.recv(timeout=0.5) == (0, T._U32.pack(0) + b"first")
        assert rx.recv(timeout=0.2) is None
    finally:
        rx.close()


# ---------------------------------------------------------------------------
# Crash + resume bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vstate", ["memory", "ooc"])
@pytest.mark.parametrize("app", APPS)
def test_crash_resume_bit_identical(stores, app, vstate, tmp_path):
    """A crash at the start of superstep min(3, last) with a checkpoint at
    every boundary; the resumed run equals the uninterrupted one byte for
    byte and really continued from the boundary."""
    root = _root(stores, app)
    kw = dict(vertex_memory_budget=2000) if vstate == "ooc" else {}
    ref = _run(root, _prog(app), **kw)
    crash = min(3, ref.supersteps - 1)
    plan = FaultPlan(specs=(FaultSpec(site="superstep", superstep=crash),))
    out = _crash_then_resume(root, app, plan, str(tmp_path / "ck"),
                             checkpoint_every=1, **kw)
    _assert_same_run(out, ref)
    assert len(out.history) == out.supersteps - crash
    ck = GraphCheckpointer(str(tmp_path / "ck"))
    *boundaries, final = ck.all_steps()
    assert boundaries and final == out.supersteps + 1
    for step in boundaries:   # out of core: interval blocks, not leaves
        assert os.path.isdir(os.path.join(ck._step_dir(step), "blocks")) \
            == (vstate == "ooc")


@pytest.mark.parametrize("mode", ["stacked", "merged", "pipeline"])
def test_crash_resume_in_every_engine_mode(stores, mode, tmp_path):
    kw = (dict(pipeline=True, stack_size=2) if mode == "pipeline"
          else dict(engine_mode=mode, tile_skipping=False))
    for app in ("pagerank", "msbfs"):
        ref = _run(stores[0], _prog(app), **kw)
        plan = FaultPlan(specs=(FaultSpec(site="barrier", superstep=2),))
        out = _crash_then_resume(stores[0], app, plan,
                                 str(tmp_path / app), checkpoint_every=2,
                                 **kw)
        _assert_same_run(out, ref)
        assert len(out.history) == out.supersteps - 2


# the file sites (leaf, block, LATEST) fire through write(): torn writes
SITES = [("superstep", "raise"), ("barrier", "raise"),
         ("ckpt.mid_write", "raise"), ("ckpt.leaf", "torn_write"),
         ("ckpt.block", "torn_write"), ("ckpt.pre_rename", "raise"),
         ("ckpt.latest", "torn_write"), ("ckpt.pre_latest", "raise")]


@pytest.mark.parametrize("site,kind", SITES, ids=lambda x: str(x))
def test_crash_at_every_site_resumes_bit_identical(stores, site, kind,
                                                   tmp_path):
    """A crash inside the engine's superstep (its start, its barrier) or
    inside the save of boundary 4 (between leaves, a torn leaf or
    interval block, before the publish, a torn LATEST, before LATEST
    moves): the resume starts from the last whole checkpoint and ends
    byte for byte as the uninterrupted run (MultiSourceBFS out of core,
    so the save writes interval blocks)."""
    kw = dict(vertex_memory_budget=2000)
    ref = _run(stores[0], _prog("msbfs"), **kw)
    plan = FaultPlan(specs=(FaultSpec(site=site, superstep=4, kind=kind,
                                      keep_bytes=7),))
    ck = str(tmp_path / "ck")
    out = _crash_then_resume(stores[0], "msbfs", plan, ck,
                             checkpoint_every=2, **kw)
    _assert_same_run(out, ref)
    # the boundary the resume took: 4 when the crash came after its
    # publish (LATEST torn or not moved), else 2 (or 4 from superstep 4)
    start = out.supersteps - len(out.history)
    assert start in (2, 4)
    if site in ("ckpt.mid_write", "ckpt.leaf", "ckpt.block",
                "ckpt.pre_rename"):
        assert start == 2


@pytest.mark.parametrize("site", ["superstep", "barrier"])
def test_preemption_saves_and_resumes(stores, site, tmp_path):
    """SIGTERM (the preempt kind) latches; at the barrier the engine saves
    and raises Preempted(ss + 1) with the prior handlers restored, and the
    resume (no periodic checkpoints) is bit-identical."""
    ref = _run(stores[0], tapps.PageRank(), n=1)
    plan = FaultPlan(specs=(FaultSpec(site=site, superstep=4,
                                      kind="preempt"),))
    before = signal.getsignal(signal.SIGTERM)
    ck = str(tmp_path / "ck")
    with pytest.raises(Preempted) as ei:
        _run(stores[0], tapps.PageRank(), n=1, checkpoint_dir=ck,
             preemptible=True, fault_plan=plan)
    assert ei.value.superstep == 5
    assert signal.getsignal(signal.SIGTERM) is before
    assert GraphCheckpointer(ck).all_steps() == [5]
    out = _run(stores[0], tapps.PageRank(), n=1, checkpoint_dir=ck,
               resume=True)
    _assert_same_run(out, ref)
    assert len(out.history) == SS - 5


def test_preemption_with_scheduled_admission(stores, tmp_path):
    """MultiSourceBFS whose admit_plan brings a fourth source in after
    superstep 1, preempted at the barrier of superstep 2: the checkpoint
    holds the spliced column and its lineage, the plan entry is not
    replayed, and values and per-query supersteps equal the
    uninterrupted run."""
    kw = dict(admit_plan=((1, (17,)),), tile_skipping=False)
    ref = _run(stores[0], _prog("msbfs"), **kw)
    assert ref.history[1].admitted_queries == (3,)
    plan = FaultPlan(specs=(FaultSpec(site="barrier", superstep=2,
                                      kind="preempt"),))
    ck = str(tmp_path / "ck")
    with pytest.raises(Preempted) as ei:
        _run(stores[0], _prog("msbfs"), checkpoint_dir=ck,
             checkpoint_every=1, preemptible=True, fault_plan=plan, **kw)
    assert ei.value.superstep == 3
    loaded = GraphCheckpointer(ck).load_graph()
    assert loaded.manifest["next_qid"] == 4
    assert loaded.manifest["queries"] == {"0": 2, "1": 11, "2": 60,
                                          "3": 17}
    retired = {g for h in ref.history[:3] for g in h.retired_queries}
    assert set(loaded.live_queries()) == {0, 1, 2, 3} - retired
    assert list(loaded.state["admitted_at"]) == [0, 0, 0, 2]
    out = _run(stores[0], _prog("msbfs"), checkpoint_dir=ck, resume=True,
               **kw)
    _assert_same_run(out, ref)
    assert all(h.admitted_queries == () for h in out.history)


def test_session_checkpoint_keeps_query_lineage(stores, tmp_path):
    """``EngineSession.checkpoint()`` after an ``admit()``: the resumed
    session holds the admitted column, numbers the next admission after
    it, and finishes equal to the uninterrupted session."""
    root = stores[0]

    def session(ck=None, resume=False):
        eng = OutOfCoreEngine(TileStore(root), EngineConfig(
            device="cpu", max_supersteps=SS, checkpoint_dir=ck,
            resume=resume))
        return eng.open_session(tapps.MultiSourceBFS(sources=(2, 11)),
                                q_slots=4)

    ref = session()
    ref.step()
    assert ref.admit([17]) == [2]
    ref.step()
    while not ref.finished:
        ref.step()
    want = ref.result()

    ck = str(tmp_path / "ck")
    sess = session(ck)
    sess.step()
    sess.admit([17])
    sess.step()
    sess.checkpoint()
    resumed = session(ck, resume=True)
    assert resumed.superstep == 2
    assert resumed.active_queries == (0, 1, 2)
    assert resumed.admit([60]) == [3]
    while not resumed.finished:
        resumed.step()
    got = resumed.result()
    assert np.array_equal(got.values[:, :3], want.values)
    assert np.array_equal(got.per_query_supersteps[:3],
                          want.per_query_supersteps)


def test_crash_resume_ooc_vstate_and_final_skip(stores, tmp_path):
    """Out-of-core vertex state round-trips through interval-block
    checkpoints (resumed under another budget), and resuming a finished
    run returns the stored result without a superstep."""
    root = stores[0]
    ref = _run(root, _prog("ppr"), vertex_memory_budget=2000)
    ck = str(tmp_path / "ooc")
    plan = FaultPlan(specs=(FaultSpec(site="barrier", superstep=5),))
    with pytest.raises(InjectedFault):
        _run(root, _prog("ppr"), vertex_memory_budget=2000,
             checkpoint_dir=ck, checkpoint_every=2, fault_plan=plan)
    steps = sorted(glob.glob(ck + "/step_*"))
    assert steps and os.path.isdir(os.path.join(steps[0], "blocks"))
    out = _run(root, _prog("ppr"), vertex_memory_budget=4000,
               checkpoint_dir=ck, resume=True)
    _assert_same_run(out, ref)
    again = _run(root, _prog("ppr"), vertex_memory_budget=2000,
                 checkpoint_dir=ck, resume=True)
    _assert_same_run(again, ref)
    assert again.history == []


def test_resume_with_different_server_count(stores, tmp_path):
    """N -> M at a superstep boundary: saved under emulated N = 4,
    resumed under N = 3 and N = 5 on a remapped assignment, both
    bit-identical (vertex state is replicated: only tiles move)."""
    root = stores[1]
    ref = _run(root, tapps.SSSP(source=0), n=4)
    ck = str(tmp_path / "resize")
    plan = FaultPlan(specs=(FaultSpec(site="superstep", superstep=4),))
    with pytest.raises(InjectedFault):
        _run(root, tapps.SSSP(source=0), n=4, checkpoint_dir=ck,
             checkpoint_every=2, fault_plan=plan)
    saved = GraphCheckpointer(ck).peek_manifest()[1]["assignment"]
    for m in (3, 5):
        # a copy each: the resumed run writes its own final checkpoint
        ck_m = str(tmp_path / f"resize_{m}")
        shutil.copytree(ck, ck_m)
        eng = OutOfCoreEngine(TileStore(root), EngineConfig(
            device="cpu", num_servers=m, max_supersteps=SS,
            checkpoint_dir=ck_m, resume=True))
        assert eng.assignment == remap_assignment(
            saved, m, eng.plan.edges_per_tile)
        got = eng.run(tapps.SSSP(source=0))
        _assert_same_run(got, ref)


def test_cli_checkpoint_crash_and_resume(tmp_path, capsys):
    argv = ["--app", "bfs", "--vertices", "2000", "--edges", "20000",
            "--tile-size", "4096", "--servers", "2", "--device", "cpu",
            "--store", str(tmp_path / "s"), "--checkpoint-dir",
            str(tmp_path / "ck"), "--checkpoint-every", "1"]
    want = tgraph.main(argv[:-4])
    with pytest.raises(InjectedFault):
        tgraph.main(argv + ["--reuse", "--inject",
                            "site=superstep,superstep=3"])
    got = tgraph.main(argv + ["--reuse", "--resume"])
    assert np.array_equal(got.values, want.values)
    assert got.supersteps == want.supersteps
    again = tgraph.main(argv + ["--reuse", "--resume"])
    assert np.array_equal(again.values, want.values)
    assert "resumed a finished run" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Elastic remap + handoff accounting, against the reference's
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(st.integers(1, 6), st.integers(1, 6), st.integers(1, 40))
def test_remap_assignment_properties(old_n, new_n, num_tiles):
    """Every tile owned once after any N -> M remap; on shrink the
    survivors keep their tiles; deterministic; equal to the reference."""
    from repro.runtime import elastic as jelastic

    rng = np.random.default_rng(old_n * 1000 + new_n * 40 + num_tiles)
    edges = rng.integers(1, 100, num_tiles)
    owner = rng.integers(0, old_n, num_tiles)
    old = [sorted(np.flatnonzero(owner == s).tolist())
           for s in range(old_n)]
    new = remap_assignment(old, new_n, edges)
    assert len(new) == new_n
    assert sorted(t for a in new for t in a) == list(range(num_tiles))
    if new_n <= old_n:
        for s in range(new_n):
            assert set(old[s]) <= set(new[s])
    assert remap_assignment(old, new_n, edges) == new
    assert jelastic.remap_assignment(old, new_n, edges) == new


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 6), st.integers(1, 6), st.integers(1, 40))
def test_handoff_plan_accounting(old_n, new_n, num_tiles):
    from repro.runtime import elastic as jelastic

    rng = np.random.default_rng(old_n + 7 * new_n + 13 * num_tiles)
    tile_bytes = rng.integers(1, 1000, num_tiles)
    edges = rng.integers(1, 100, num_tiles)
    owner = rng.integers(0, old_n, num_tiles)
    old = [sorted(np.flatnonzero(owner == s).tolist()) for s in range(old_n)]
    new = remap_assignment(old, new_n, edges)
    plan = handoff_plan(old, new, tile_bytes)
    moved = {t for t, _s, _d in plan["moves"]}
    src = {t: s for s, ts in enumerate(old) for t in ts}
    dst = {t: s for s, ts in enumerate(new) for t in ts}
    for t in set(range(num_tiles)) - moved:
        assert src[t] == dst[t]
    for t, s, d in plan["moves"]:
        assert src.get(t, -1) == s and dst[t] == d and s != d
    assert plan["bytes"] == sum(int(tile_bytes[t]) for t in moved)
    assert plan["bytes"] == sum(plan["per_dst_bytes"].values())
    assert plan == jelastic.handoff_plan(old, new, tile_bytes)


def test_remap_4_to_3_and_2_to_5_non_divisible():
    edges = np.arange(1, 14)[::-1]      # 13 tiles, uneven weights
    old4 = [[0, 4, 8, 12], [1, 5, 9], [2, 6, 10], [3, 7, 11]]
    new3 = remap_assignment(old4, 3, edges)
    assert sorted(t for a in new3 for t in a) == list(range(13))
    for s in range(3):
        assert set(old4[s]) <= set(new3[s])
    old2 = [[0, 2, 4, 6, 8, 10, 12], [1, 3, 5, 7, 9, 11]]
    new5 = remap_assignment(old2, 5, edges)
    assert sorted(t for a in new5 for t in a) == list(range(13))
    assert all(len(a) > 0 for a in new5)
    plan = handoff_plan(old2, new5, np.full(13, 10))
    assert plan["bytes"] == 10 * len({t for t, _, _ in plan["moves"]})
    with pytest.raises(ValueError):
        remap_assignment(old2, 0, edges)


# ---------------------------------------------------------------------------
# runtime.ft: the signal handlers are always restored
# ---------------------------------------------------------------------------

def test_ftloop_context_manager_restores_handlers_on_raise(tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager

    def marker(signum, frame):  # pragma: no cover - never delivered
        pass

    prev_term = signal.signal(signal.SIGTERM, marker)
    prev_int = signal.getsignal(signal.SIGINT)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            with FaultTolerantLoop(CheckpointManager(str(tmp_path))) as ft:
                assert not ft.preempted
                raise RuntimeError("boom")
        assert signal.getsignal(signal.SIGTERM) is marker
        assert signal.getsignal(signal.SIGINT) is prev_int
    finally:
        signal.signal(signal.SIGTERM, prev_term)


def test_ftloop_bare_construction_and_preemption(tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager

    prev = signal.getsignal(signal.SIGTERM)
    ft = FaultTolerantLoop(CheckpointManager(str(tmp_path)), save_every=0)
    assert signal.getsignal(signal.SIGTERM) is not prev
    assert not ft.maybe_save(3, {"w": np.zeros(2)})
    os.kill(os.getpid(), signal.SIGTERM)      # latched, not delivered
    assert ft.should_stop()
    assert ft.maybe_save(3, {"w": np.zeros(2)})
    assert ft.ckpt.all_steps() == [3]
    ft.restore_handlers()
    assert signal.getsignal(signal.SIGTERM) is prev
    ft.restore_handlers()               # idempotent


# ---------------------------------------------------------------------------
# Supervised spawned clusters on the CPU
# ---------------------------------------------------------------------------

def _cluster(root, progs, n, tmp_path, specs, **kw):
    eng_kw = dict(max_supersteps=SS, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=2)
    eng_kw.update(kw.pop("engine", {}))
    if specs:
        eng_kw["fault_plan"] = FaultPlan(specs=specs,
                                         marker_dir=str(tmp_path / "mk"))
    kw = dict(dict(timeout_seconds=60, launch_timeout_seconds=300), **kw)
    return run_cluster(root, progs, ClusterConfig(
        num_servers=n, device="cpu", engine=EngineConfig(**eng_kw), **kw))


@pytest.mark.parametrize("transport", ["shm", "tcp"])
@pytest.mark.parametrize("policy", ["restart", "shrink"])
def test_spawned_cluster_kill_resumes_bit_identical(stores, policy,
                                                    transport, tmp_path):
    """A rank killed at the barrier of superstep 5 (os._exit, mid-run):
    the supervisor tears the attempt down, respawns N ranks (restart) or
    N - 1 (shrink, on the remapped saved assignment), the first program
    resumes from its boundary-4 checkpoint (published before rank 0's
    superstep-4 frame, which the killed rank received, and the last one:
    boundary 6 needs the killed rank's superstep-5 frame), and all eight
    apps answer byte for byte as one process."""
    root = stores[1]
    n = 3 if policy == "shrink" else 2
    progs = [_prog(a) for a in APPS]
    out = _cluster(root, progs, n, tmp_path,
                   (FaultSpec(site="barrier", superstep=5, rank=n - 1,
                              kind="kill"),), on_failure=policy,
                   transport=transport)
    assert out.restarts == 1 and out.verified
    new_n = n - 1 if policy == "shrink" else n
    assert out.final_servers == new_n == len(out.rank_reports)
    if policy == "shrink":
        plan = TileStore(root).load_plan()
        from repro_torch.core.partition import assign_tiles

        want = remap_assignment(assign_tiles(plan.num_tiles, n), new_n,
                                plan.edges_per_tile)
        assert out.rank_reports[0]["final_assignment"] == want
    # the first program resumed at boundary 4, the others ran whole
    first = out.results[0]
    assert len(first.history) == first.supersteps - 4
    for a, app in enumerate(APPS):
        _assert_same_run(out.results[a], _run(root, _prog(app), n=n))


def test_spawned_cluster_preemption_saves_and_resumes(stores, tmp_path):
    """Spot reclaim: a preemptible rank SIGTERM'd at superstep 4 saves at
    the barrier and exits cleanly; the restart resumes at boundary 5 with
    no periodic checkpoints, bit-identical."""
    root = stores[0]
    out = _cluster(root, [tapps.PageRank()], 2, tmp_path,
                   (FaultSpec(site="superstep", superstep=4, rank=0,
                              kind="preempt"),), on_failure="restart",
                   engine=dict(checkpoint_every=0, preemptible=True))
    assert out.restarts == 1
    assert len(out.results[0].history) == out.results[0].supersteps - 5
    _assert_same_run(out.results[0], _run(root, tapps.PageRank(), n=2))


def test_spawned_cluster_preemption_fails_without_supervision(stores,
                                                              tmp_path):
    with pytest.raises(ClusterFailure, match="preempted") as ei:
        _cluster(stores[0], [tapps.PageRank()], 2, tmp_path,
                 (FaultSpec(site="superstep", superstep=2, rank=1,
                            kind="preempt"),),
                 engine=dict(checkpoint_every=0, preemptible=True))
    assert ei.value.preempted and ei.value.dead_ranks == [1]


def test_spawned_cluster_dropped_frame_restarts(stores, tmp_path):
    """A frame lost on the wire: the peer's exchange times out, the
    attempt fails, the restart resumes from the last boundary."""
    root = stores[0]
    out = _cluster(root, [tapps.WCC()], 2, tmp_path,
                   (FaultSpec(site="transport.send", superstep=3, rank=1,
                              kind="drop_frame"),), on_failure="restart",
                   timeout_seconds=8)
    assert out.restarts == 1
    _assert_same_run(out.results[0], _run(root, tapps.WCC(), n=2))


def test_spawned_cluster_restart_budget_exhausted(stores, tmp_path):
    """A fault that is not once kills every attempt: max_restarts
    respawns, then the ClusterFailure surfaces (no endless loop), every
    child reaped."""
    t0 = time.monotonic()
    with pytest.raises(ClusterFailure, match="died") as ei:
        _cluster(stores[0], [tapps.PageRank()], 2, tmp_path,
                 (FaultSpec(site="superstep", superstep=1, rank=0,
                            kind="kill", once=False),),
                 on_failure="restart", max_restarts=1)
    assert time.monotonic() - t0 < 120
    assert ei.value.dead_ranks == [0] and not ei.value.preempted
    for pid in ei.value.pids:
        deadline = time.monotonic() + 10
        while True:
            try:
                os.kill(pid, 0)
            except (ProcessLookupError, PermissionError):
                break
            assert time.monotonic() < deadline, f"child {pid} leaked"
            time.sleep(0.1)


def test_spawned_cluster_restart_without_checkpoints_reruns(stores,
                                                            tmp_path):
    """on_failure="restart" with no checkpoint directory: a clean rerun
    from superstep 0, as bit-identical."""
    root = stores[0]
    out = _cluster(root, [tapps.BFS(source=0)], 2, tmp_path,
                   (FaultSpec(site="barrier", superstep=2, rank=1,
                              kind="kill"),), on_failure="restart",
                   engine=dict(checkpoint_dir=None, checkpoint_every=0))
    assert out.restarts == 1
    assert len(out.results[0].history) == out.results[0].supersteps
    _assert_same_run(out.results[0], _run(root, tapps.BFS(source=0), n=2))


def test_cli_cluster_fault_drill(tmp_path, capsys):
    out = tgraph.main([
        "--cluster", "--servers", "2", "--device", "cpu", "--app",
        "pagerank", "--vertices", "2000", "--edges", "20000",
        "--tile-size", "1024", "--supersteps", "6", "--store",
        str(tmp_path / "s"), "--checkpoint-dir", str(tmp_path / "ck"),
        "--checkpoint-every", "2", "--on-failure", "restart",
        "--inject", "rank=1,superstep=3,site=superstep,kind=kill",
        "--verify-clean"])
    assert out.restarts == 1 and out.verified
    assert glob.glob(str(tmp_path / "ck" / "fault_markers" / "*.fired"))
    text = capsys.readouterr().out
    assert "1 restarts -> 2 servers" in text
    assert "verify-clean: byte-identical" in text
