"""The port's checkpoint files (``train.checkpoint``, ``core.checkpoint``)
against the JAX package's, on the CPU.

The format is the reference's byte for byte — ``step_%08d`` directories,
``meta.json`` with ``leaves`` and ``extra``, one ``np.save`` file a leaf
(or ``.npy.zst``), the ``__empty_dict__`` marker, ``LATEST``,
keep-last-k — so each package resumes the other's checkpoints:

  * the checkpoint manager: round trips of numpy and torch leaves,
    compression, restore onto a device, ``like`` validation, a reader that
    never sees a torn checkpoint whatever write is cut where, and the
    fault-tolerant loop's resume;
  * the graph checkpointer: interval blocks hardlinked when unchanged,
    first publish wins between two writers, ``peek_manifest``;
  * **cross-loads both ways**: a checkpoint the reference's engine wrote
    before an injected crash resumes in the port, and the port's in the
    reference, out of core (interval blocks) among them; the result
    equals the reference's uninterrupted run — ``array_equal`` for the
    min/max apps and InDegree, ``rtol=1e-5, atol=1e-6`` for PageRank and
    PPR (another order of summation, ROADMAP.md queue C);
  * the manifest keys, leaf names, shapes and dtypes and the block files
    equal the reference's for the same run, and equal in value for the
    exact apps.

The reference runs under ``JAX_PLATFORMS=cpu``, the port on
``device="cpu"``.
"""
import glob
import json
import os
import tempfile

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # deterministic fallback, see _hypothesis_compat
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import apps as japps
from repro.core.checkpoint import GraphCheckpointer as JGraphCheckpointer
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import OutOfCoreEngine as JEngine
from repro.core.vstate import VertexStateStore as JVertexStateStore
from repro.graphio import spe as jspe
from repro.graphio.formats import TileStore as JTileStore
from repro.runtime import faults as jfaults
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.core import apps as tapps
from repro_torch.core.checkpoint import GraphCheckpointer
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.core.vstate import VertexStateStore
from repro_torch.graphio.formats import TileStore
from repro_torch.runtime.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.runtime.ft import (FailureInjector, FaultTolerantLoop,
                                    SimulatedFailure)
from repro_torch.train.checkpoint import CheckpointManager

SS = 12
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
EXACT_APPS = ("wcc", "bfs", "indegree", "msbfs", "sssp", "landmarks")


def _make_store(weighted, seed=7, nv=220, ne=1400, tile_size=96):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    _, i = np.unique(src * nv + dst, return_index=True)
    src, dst = src[i], dst[i]
    val = (rng.uniform(0.1, 10.0, len(src)).astype(np.float32)
           if weighted else None)
    root = tempfile.mkdtemp(prefix=f"tckpt_store_{int(weighted)}_")
    jspe.preprocess_arrays(src, dst, val, nv, JTileStore(root), tile_size)
    return root


@pytest.fixture(scope="module")
def stores():
    """(unweighted root, weighted root) shared by every test here."""
    return _make_store(False), _make_store(True)


def _progs(pkg):
    return {"pagerank": pkg.PageRank, "wcc": pkg.WCC,
            "bfs": lambda: pkg.BFS(source=0), "indegree": pkg.InDegree,
            "ppr": lambda: pkg.PersonalizedPageRank(seeds=(1, 7, 50)),
            "msbfs": lambda: pkg.MultiSourceBFS(sources=(2, 11, 60)),
            "sssp": lambda: pkg.SSSP(source=0),
            "landmarks": lambda: pkg.LandmarkDistances(landmarks=(0, 9, 33))}


def _root(stores, app):
    return stores[1] if app in ("sssp", "landmarks") else stores[0]


def _port_run(root, app, **kw):
    return OutOfCoreEngine(TileStore(root), EngineConfig(
        device="cpu", num_servers=2, max_supersteps=SS, **kw)).run(
            _progs(tapps)[app]())


def _ref_run(root, app, **kw):
    return JEngine(JTileStore(root), JConfig(
        num_servers=2, max_supersteps=SS, **kw)).run(_progs(japps)[app]())


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_numpy_and_torch_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"a": torch.arange(6.0).reshape(2, 3),
                        "nested": {"b": np.asarray([1, 2], np.int32)}},
             "empty": {}, "step": np.asarray(7, np.int32)}
    mgr.save(7, state)
    mgr.save(12, state)
    mgr.save(20, state, extra_meta={"note": "x"})
    assert mgr.all_steps() == [12, 20]          # keep=2 collected step 7
    step, got = mgr.restore()
    assert step == 20
    assert isinstance(got["params"]["a"], np.ndarray)
    np.testing.assert_array_equal(got["params"]["a"],
                                  np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(got["params"]["nested"]["b"], [1, 2])
    assert got["empty"] == {} and int(got["step"]) == 7
    with open(tmp_path / "step_00000020" / "meta.json") as f:
        meta = json.load(f)
    assert meta["extra"] == {"note": "x"}
    assert meta["leaves"]["params.a"] == {"shape": [2, 3],
                                          "dtype": "float32"}
    assert os.path.exists(tmp_path / "step_00000020" / "empty.__empty_dict__.npy")


def test_checkpoint_compressed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), compress=True)
    mgr.save(1, {"w": np.arange(4096, dtype=np.float32).reshape(64, 64)})
    assert glob.glob(str(tmp_path / "step_00000001" / "w.npy.zst"))
    _, got = mgr.restore()
    np.testing.assert_array_equal(
        got["w"], np.arange(4096, dtype=np.float32).reshape(64, 64))


def test_restore_onto_a_device_and_like(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": np.ones((2, 2), np.float32), "i": {"k": np.arange(3)}})
    _, got = mgr.restore(device="cpu")
    assert isinstance(got["w"], torch.Tensor)
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.float32
    assert torch.equal(got["i"]["k"], torch.arange(3))
    mgr.restore(like={"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(like={"w": np.zeros((2, 3), np.float32)})
    # the reference documents the same check and skips it (ROADMAP.md C)
    _, jgot = JCheckpointManager(str(tmp_path)).restore(
        like={"w": np.zeros((2, 3), np.float32)})
    assert np.asarray(jgot["w"]).shape == (2, 2)
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(like={"w": torch.zeros(2, 2, dtype=torch.float64)})
    with pytest.raises(ValueError, match="'missing'"):
        mgr.restore(like={"missing": np.zeros(1)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


CKPT_SITES = ["ckpt.mid_write", "ckpt.leaf", "ckpt.pre_rename",
              "ckpt.latest", "ckpt.pre_latest"]


@settings(max_examples=20, deadline=None)
@given(st.sampled_from(CKPT_SITES), st.integers(0, 128),
       st.sampled_from(["raise", "torn_write"]))
def test_checkpoint_crash_atomicity(site, keep_bytes, kind):
    """Kill the writer at every named point of the staged write, a file
    torn at any byte: a reader sees the previous whole checkpoint (or,
    when only the LATEST update was lost, a whole newer one)."""
    if kind == "torn_write" and site in ("ckpt.mid_write", "ckpt.pre_rename",
                                         "ckpt.pre_latest"):
        return       # pure check() sites: no write to tear there
    with tempfile.TemporaryDirectory() as d:
        old = {"params": {"a": np.arange(6.0).reshape(2, 3)},
               "step": np.asarray(4, np.int32)}
        new = {"params": {"a": torch.full((2, 3), 7.0, dtype=torch.float64)},
               "step": np.asarray(9, np.int32)}
        CheckpointManager(d).save(4, old)
        plan = FaultPlan(specs=(FaultSpec(
            site=site, kind=kind, keep_bytes=keep_bytes, superstep=9),))
        wr = CheckpointManager(d, fault=plan.injector())
        try:
            wr.save(9, new)
            crashed = False
        except InjectedFault:
            crashed = True
        step, got = CheckpointManager(d).restore()
        if crashed and site not in ("ckpt.latest", "ckpt.pre_latest"):
            assert step == 4        # the torn step 9 never published
        else:
            assert step in (4, 9)   # only the pointer update was lost
        want = old["params"]["a"] if step == 4 else np.full((2, 3), 7.0)
        np.testing.assert_array_equal(got["params"]["a"], want)
        assert int(got["step"]) == step


def test_checkpoint_unreadable_latest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": np.zeros(4)})
    with open(str(tmp_path / "LATEST"), "w") as f:
        f.write("garb")             # torn pointer content
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    with open(str(tmp_path / "LATEST"), "w") as f:
        f.write("77")               # a pointer to a missing step
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_failure_injection_and_recovery(tmp_path):
    """A deterministic numpy "training" loop under FaultTolerantLoop: die
    at step 5 after the step-4 save, resume from it, and end equal to the
    straight run; ``resume_or_init`` onto a device gives tensors."""
    def step(state, s):
        return {"w": state["w"] * 0.5 + s, "n": state["n"] + 1}

    def init():
        return {"w": np.ones(3), "n": np.asarray(0)}

    mgr = CheckpointManager(str(tmp_path))
    inj = FailureInjector({5})

    def job():
        with FaultTolerantLoop(mgr, save_every=2,
                               on_preempt_save=False) as ft:
            start, state = ft.resume_or_init(init)
            for s in range(start, 8):
                inj.check(s)
                state = step(state, s)
                ft.maybe_save(s + 1, state)
            return state

    with pytest.raises(SimulatedFailure):
        job()
    got = job()
    want = init()
    for s in range(8):
        want = step(want, s)
    np.testing.assert_array_equal(got["w"], want["w"])
    assert int(got["n"]) == 8 and inj.failures == 1
    with FaultTolerantLoop(mgr, on_preempt_save=False) as ft:
        s, state = ft.resume_or_init(init, device="cpu")
    assert s == 8 and isinstance(state["w"], torch.Tensor)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_train_checkpoints_cross_load(tmp_path, writer):
    state = {"params": {"a": np.arange(6.0).reshape(2, 3)}, "opt": {},
             "i": np.asarray([1, 2], np.int32)}
    for compress in (False, True):
        d = str(tmp_path / f"c{int(compress)}")
        w, r = ((CheckpointManager, JCheckpointManager) if writer == "port"
                else (JCheckpointManager, CheckpointManager))
        w(d, compress=compress).save(5, state)
        step, got = r(d).restore()
        assert step == 5 and got["opt"] == {}
        np.testing.assert_array_equal(np.asarray(got["params"]["a"]),
                                      state["params"]["a"])
        np.testing.assert_array_equal(np.asarray(got["i"]), state["i"])
        assert np.asarray(got["i"]).dtype == np.int32


# ---------------------------------------------------------------------------
# GraphCheckpointer
# ---------------------------------------------------------------------------

def _small_vstore(cls=VertexStateStore):
    vs = cls(np.array([0, 4, 8, 12]))
    vs.add_array("value", np.arange(12, dtype=np.float32))
    vs.add_array("deg", np.ones((12, 2), dtype=np.int32))
    return vs


def test_graph_checkpointer_hardlinks_unchanged_blocks(tmp_path):
    ck = GraphCheckpointer(str(tmp_path))
    vs = _small_vstore()
    d1 = ck.save_graph(1, {"updated_ids": np.arange(3)},
                       {"superstep": 1, "assignment": [[0]]}, vstore=vs)
    vs.write_block("value", 1, np.full(4, 7.0, np.float32))
    d2 = ck.save_graph(2, {"updated_ids": np.arange(3)},
                       {"superstep": 2, "assignment": [[0]]}, vstore=vs)
    for k in range(3):
        for name in ("value", "deg"):
            fn = f"{name}.{k}.blk"
            same = os.stat(os.path.join(d2, "blocks", fn)).st_ino == \
                os.stat(os.path.join(d1, "blocks", fn)).st_ino
            assert same == ((name, k) != ("value", 1)), fn
    got = ck.load_graph(2)
    np.testing.assert_array_equal(
        got.vstate["value"],
        np.concatenate([np.arange(4), np.full(4, 7.0),
                        np.arange(8, 12)]).astype(np.float32))
    np.testing.assert_array_equal(got.vstate["deg"],
                                  np.ones((12, 2), np.int32))
    assert got.manifest["superstep"] == 2
    assert got.manifest["kind"] == "graphh-superstep"


def test_graph_checkpointer_first_publish_wins(tmp_path):
    """Two writers of one superstep (a preempted rank racing rank 0): the
    second discards its staged copy and one whole checkpoint stays."""
    a = GraphCheckpointer(str(tmp_path))
    b = GraphCheckpointer(str(tmp_path))
    st_ = {"values": np.arange(5.0)}
    man = {"superstep": 3, "assignment": [[0], [1]]}
    a.save_graph(3, st_, man)
    b.save_graph(3, {"values": np.arange(5.0) + 1}, man)   # loses
    assert a.all_steps() == [3]
    assert not glob.glob(str(tmp_path) + "/*.tmp.*")
    got = b.load_graph()
    np.testing.assert_array_equal(got.state["values"], np.arange(5.0))


def test_peek_manifest_empty_and_populated(tmp_path):
    ck = GraphCheckpointer(str(tmp_path))
    assert ck.peek_manifest() is None
    assert ck.load_graph() is None
    ck.save_graph(4, {"values": np.zeros(2)},
                  {"superstep": 4, "assignment": [[0, 1]],
                   "active_q": [1], "queries": {"0": 5, "1": 9}})
    step, man = ck.peek_manifest()
    assert step == 4 and man["assignment"] == [[0, 1]]
    assert ck.load_graph().live_queries() == {1: 9}


GRAPH_SITES = ["ckpt.mid_write", "ckpt.leaf", "ckpt.block",
               "ckpt.pre_rename", "ckpt.latest", "ckpt.pre_latest"]


@settings(max_examples=24, deadline=None)
@given(st.sampled_from(GRAPH_SITES), st.integers(0, 64),
       st.sampled_from(["raise", "torn_write"]))
def test_graph_checkpoint_crash_atomicity(site, keep_bytes, kind):
    if kind == "torn_write" and site in ("ckpt.mid_write", "ckpt.pre_rename",
                                         "ckpt.pre_latest"):
        return
    with tempfile.TemporaryDirectory() as d:
        base = GraphCheckpointer(d)
        vs = _small_vstore()
        state = {"updated_ids": np.arange(5), "x": np.eye(3)}
        base.save_graph(2, state, {"superstep": 2, "assignment": [[0], [1]]},
                        vstore=vs)
        plan = FaultPlan(specs=(FaultSpec(
            site=site, kind=kind, keep_bytes=keep_bytes, superstep=4),))
        wr = GraphCheckpointer(d, fault=plan.injector())
        vs.write_block("value", 0, np.full(4, 9.0, np.float32))
        try:
            wr.save_graph(4, state, {"superstep": 4, "assignment": [[0, 1]]},
                          vstore=vs)
            crashed = False
        except InjectedFault:
            crashed = True
        got = GraphCheckpointer(d).load_graph()
        if crashed and site not in ("ckpt.latest", "ckpt.pre_latest"):
            assert got.step == 2
            np.testing.assert_array_equal(got.vstate["value"],
                                          np.arange(12, dtype=np.float32))
        else:
            assert got.step in (2, 4)
        assert got.manifest["superstep"] == got.step
        np.testing.assert_array_equal(got.state["x"], np.eye(3))


def test_latest_pointer_crash_leaves_prior_resumable(tmp_path):
    base = GraphCheckpointer(str(tmp_path))
    base.save_graph(2, {"v": np.arange(3.0)}, {"superstep": 2,
                                               "assignment": [[0]]})
    plan = FaultPlan(specs=(FaultSpec(site="ckpt.pre_latest",
                                      superstep=4),))
    wr = GraphCheckpointer(str(tmp_path), fault=plan.injector())
    with pytest.raises(InjectedFault):
        wr.save_graph(4, {"v": np.arange(3.0) * 2}, {"superstep": 4,
                                                     "assignment": [[0]]})
    with open(str(tmp_path / "LATEST")) as f:
        assert int(f.read()) == 2
    rd = GraphCheckpointer(str(tmp_path))
    assert rd.latest_step() == 2
    assert rd.all_steps() == [2, 4]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_graph_checkpoint_blocks_cross_load(tmp_path, writer):
    """Interval blocks one package writes (warm and spilled ones among
    them) load in the other, hardlinks included."""
    w_ck, w_vs, r_ck = (
        (GraphCheckpointer, VertexStateStore, JGraphCheckpointer)
        if writer == "port"
        else (JGraphCheckpointer, JVertexStateStore, GraphCheckpointer))
    vs = w_vs(np.array([0, 40, 90, 150, 200]), 600, str(tmp_path / "spill"))
    vals = np.random.default_rng(0).random((200, 3)).astype(np.float32)
    vs.add_array("value", vals)
    vs.add_array("deg", np.arange(200, dtype=np.int64))
    ck = w_ck(str(tmp_path / "ck"))
    ck.save_graph(1, {"updated_ids": np.arange(4)}, {"superstep": 1})
    ck.save_graph(2, {"updated_ids": np.arange(4)}, {"superstep": 2},
                  vstore=vs)
    vals[40:90] = 7.0
    vs.write_block("value", 1, vals[40:90])
    ck.save_graph(3, {"updated_ids": np.arange(4)}, {"superstep": 3},
                  vstore=vs)
    got = r_ck(str(tmp_path / "ck")).load_graph()
    assert got.step == 3
    np.testing.assert_array_equal(got.vstate["value"], vals)
    np.testing.assert_array_equal(got.vstate["deg"], np.arange(200))
    vs.close()


# ---------------------------------------------------------------------------
# Engine checkpoints across the two packages
# ---------------------------------------------------------------------------

CROSS = [("pagerank", {}), ("ppr", {"vertex_memory_budget": 2000}),
         ("wcc", {"vertex_memory_budget": 2000}), ("bfs", {}),
         ("indegree", {}), ("msbfs", {}), ("sssp", {}),
         ("landmarks", {"vertex_memory_budget": 4000})]


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("app,kw", CROSS, ids=[a for a, _ in CROSS])
def test_engine_checkpoint_cross_load(stores, app, kw, writer, tmp_path):
    """One package's engine crashes at the start of superstep 3 (after its
    boundary-2 save); the other resumes from that checkpoint and finishes
    equal to the reference's uninterrupted run."""
    root = _root(stores, app)
    ref = _ref_run(root, app, **kw)
    crash = min(3, ref.supersteps - 1)
    ck = str(tmp_path / "ck")
    if writer == "reference":
        plan = jfaults.FaultPlan(specs=(jfaults.FaultSpec(
            site="superstep", superstep=crash),))
        with pytest.raises(jfaults.InjectedFault):
            _ref_run(root, app, checkpoint_dir=ck, checkpoint_every=1,
                     fault_plan=plan, **kw)
        got = _port_run(root, app, checkpoint_dir=ck, resume=True, **kw)
    else:
        plan = FaultPlan(specs=(FaultSpec(site="superstep",
                                          superstep=crash),))
        with pytest.raises(InjectedFault):
            _port_run(root, app, checkpoint_dir=ck, checkpoint_every=1,
                      fault_plan=plan, **kw)
        got = _ref_run(root, app, checkpoint_dir=ck, resume=True, **kw)
    assert len(got.history) == ref.supersteps - crash
    assert got.supersteps == ref.supersteps
    if app in EXACT_APPS:
        assert np.array_equal(got.values, ref.values)
        if ref.per_query_supersteps is not None:
            assert np.array_equal(got.per_query_supersteps,
                                  ref.per_query_supersteps)
    else:
        np.testing.assert_allclose(got.values, ref.values, **SUM_TOL)
    if "vertex_memory_budget" in kw:
        assert glob.glob(ck + "/step_*/blocks/value.0.blk")


def _meta(d):
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "step_*", "meta.json"))):
        with open(p) as f:
            out[os.path.basename(os.path.dirname(p))] = json.load(f)
    return out


def _files(d):
    return sorted(os.path.relpath(p, d) for p in
                  glob.glob(os.path.join(d, "step_*", "**"), recursive=True))


@pytest.mark.parametrize("app,kw", CROSS, ids=[a for a, _ in CROSS])
def test_manifest_matches_reference(stores, app, kw, tmp_path):
    """The same run with a checkpoint at every boundary writes, in each
    package, the same steps and files, the same manifest keys and the same
    leaf names with the same shapes and dtypes; for the exact apps the
    manifests and leaves are equal in value too."""
    root = _root(stores, app)
    tk, jk = str(tmp_path / "port"), str(tmp_path / "ref")
    _port_run(root, app, checkpoint_dir=tk, checkpoint_every=1,
              checkpoint_keep=SS + 2, **kw)
    _ref_run(root, app, checkpoint_dir=jk, checkpoint_every=1,
             checkpoint_keep=SS + 2, **kw)
    tm, jm = _meta(tk), _meta(jk)
    assert list(tm) == list(jm) and len(tm) > 1
    exact = app in EXACT_APPS
    if exact:
        assert _files(tk) == _files(jk)
    for step in tm:
        t, j = tm[step], jm[step]
        assert sorted(t["extra"]) == sorted(j["extra"])
        assert t["step"] == j["step"]
        t_leaves, j_leaves = t["leaves"], j["leaves"]
        assert sorted(t_leaves) == sorted(j_leaves)
        for name in t_leaves:
            assert t_leaves[name]["dtype"] == j_leaves[name]["dtype"], name
            if exact or name != "updated_ids":
                assert t_leaves[name] == j_leaves[name], name
        if exact:
            for key in t["extra"]:
                if key != "vstate":
                    assert t["extra"][key] == j["extra"][key], key
        _, t_state = CheckpointManager(tk).restore(t["step"])
        _, j_state = JCheckpointManager(jk).restore(j["step"])
        if exact:
            for name in t_leaves:
                a, b = t_state, j_state
                for part in name.split("."):
                    a, b = a.get(part, a), b.get(part, b)
                if not isinstance(a, dict):
                    assert np.array_equal(a, b), (step, name)
    if "vertex_memory_budget" in kw:
        tv = [m["extra"]["vstate"] for m in tm.values()
              if "vstate" in m["extra"]]
        jv = [m["extra"]["vstate"] for m in jm.values()
              if "vstate" in m["extra"]]
        assert tv and len(tv) == len(jv)
        for a, b in zip(tv, jv):
            assert a["splitter"] == b["splitter"]
            assert sorted(a["arrays"]) == sorted(b["arrays"])
            for name in a["arrays"]:
                assert ([e["file"] for e in a["arrays"][name]["blocks"]]
                        == [e["file"] for e in b["arrays"][name]["blocks"]])
                assert (a["arrays"][name]["dtype"], a["arrays"][name]["tail"]) \
                    == (b["arrays"][name]["dtype"], b["arrays"][name]["tail"])


def test_queued_admissions_are_not_checkpointed(stores, tmp_path):
    """A session checkpointed while an ``admit()`` seed still waits for a
    slot resumes without it, in both packages: the manifest holds the
    spliced columns only, while ``next_qid`` counts the queued one, so the
    resumed session numbers its next admission after it (ROADMAP.md
    queue C)."""
    got = {}
    for pkg, eng_cls, cfg_cls, store_cls, apps, extra in (
            ("port", OutOfCoreEngine, EngineConfig, TileStore, tapps,
             dict(device="cpu")),
            ("reference", JEngine, JConfig, JTileStore, japps, {})):
        ck = str(tmp_path / pkg)

        def session(resume):
            eng = eng_cls(store_cls(stores[0]), cfg_cls(
                max_supersteps=SS, checkpoint_dir=ck, resume=resume,
                **extra))
            return eng.open_session(apps.MultiSourceBFS(sources=(2, 11)),
                                    q_slots=2)

        sess = session(False)
        sess.step()
        assert sess.admit([17]) == [2]      # no free slot: it stays queued
        sess.checkpoint()
        back = session(True)
        got[pkg] = (back.superstep, back.active_queries, back.next_qid,
                    sorted(back.query_seeds))
    assert got["port"] == got["reference"] == (1, (0, 1), 3, [0, 1])
