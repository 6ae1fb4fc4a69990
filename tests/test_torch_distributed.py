"""The port's device collectives and process-group engine, on gloo with
spawned CPU processes (one launch per world size runs every case).

Collectives (``comm.hybrid_broadcast`` in its dense, sparse and hybrid
modes) over rows owned by one rank each: every mode gives the owner's
value bits exactly — -0.0 and +-inf included — where a cell was updated
and the old bits elsewhere, ``[V, Q]`` flattens to cells, the overflow
guard turns a sparse step whose largest per-rank count exceeds the
capacity into a dense one on every rank, and ``value_dtype`` rounds the
sparse branch's values through bfloat16.  Against the JAX package's
collectives (run under ``jax.vmap`` with an axis name, one mapped index a
rank) the values are equal, except that the reference's dense sum of
+0.0-masked values turns an updated -0.0 into +0.0.

``DistributedGABEngine`` at world sizes 2 and 4 for PageRank,
MultiSourceBFS and PersonalizedPageRank in every comm mode equals the
port's ``OutOfCoreEngine`` bit for bit, on every rank; against the
reference ``OutOfCoreEngine`` (``JAX_PLATFORMS=cpu``) MultiSourceBFS is
``array_equal`` and the sum apps within ``rtol=1e-5, atol=1e-6``.

The JAX package is imported inside the tests only: the spawned ranks
import this module and need only torch.
"""
import multiprocessing as mp
import os
import queue
import tempfile
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import apps as tapps
from repro_torch.core import comm
from repro_torch.core.distributed import (DistConfig, DistributedGABEngine,
                                          init_process_group)
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio.formats import TileStore

SS = 12                      # superstep cap: parity must hold at any cap
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
SEEDS = (0, 7, 113, 250)
NV = 1000
MODES = ("dense", "sparse", "hybrid")
# (name, density, Q, mode, capacity, value dtype, rows limited to rank 0)
CASES = [
    *[(f"{m}-d{d}", d, None, m, None, None, False)
      for m in MODES for d in (0.0, 0.01, 0.3, 0.9)],
    *[(f"{m}-vq", 0.2, 3, m, None, None, False) for m in MODES],
    ("guard-sparse", 0.3, None, "sparse", 64, None, False),
    ("guard-hybrid", 0.35, None, "hybrid", 64, None, True),
    ("guard-hybrid-fits", 0.02, None, "hybrid", 64, None, False),
    ("bf16-sparse", 0.05, None, "hybrid", None, "bfloat16", False),
    ("bf16-dense", 0.6, None, "hybrid", None, "bfloat16", False),
    ("bf16-vq", 0.05, 2, "sparse", None, "bfloat16", False),
]


def _case_data(name, density, q, world, only_rank0):
    """Global (old, new, updated, owner) of one case: row r belongs to
    rank ``owner[r]`` (contiguous blocks); old and new hold -0.0 and
    +-inf among normal values."""
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = (NV,) if q is None else (NV, q)
    special = np.array([-0.0, np.inf, -np.inf, 0.0], np.float32)

    def values():
        v = rng.normal(size=shape).astype(np.float32)
        pick = rng.random(shape) < 0.1
        v[pick] = rng.choice(special, size=int(pick.sum()))
        return v

    old, new = values(), values()
    updated = rng.random(shape) < density
    owner = (np.arange(NV) * world) // NV
    if only_rank0:
        updated &= (owner == 0).reshape((NV,) + (1,) * (len(shape) - 1))
    return old, new, updated, owner


def _local_inputs(old, new, updated, owner, rank):
    mine = (owner == rank).reshape((NV,) + (1,) * (old.ndim - 1))
    upd = updated & mine
    return (torch.from_numpy(old), torch.from_numpy(np.where(upd, new, 0)),
            torch.from_numpy(upd))


def _collective_cases(rank, world):
    out = {}
    for name, density, q, mode, cap, vdt, only0 in CASES:
        old, new, updated, owner = _case_data(name, density, q, world, only0)
        res, dens, branch = comm.hybrid_broadcast(
            *_local_inputs(old, new, updated, owner, rank), None,
            capacity=cap, mode=mode,
            value_dtype=None if vdt is None else getattr(torch, vdt))
        out[name] = (res.numpy(), dens, branch)
    return out


def _engine_progs():
    return {"pagerank": tapps.PageRank(),
            "msbfs": tapps.MultiSourceBFS(sources=SEEDS),
            "ppr": tapps.PersonalizedPageRank(seeds=SEEDS)}


def _engine_cases(store_root):
    store = TileStore(store_root)
    store.load_meta()
    plan = store.load_plan()
    tiles = [store.read_tile(t) for t in range(plan.num_tiles)]
    ind, outd = store.load_degrees()
    out = {}
    runs = [(app, mode, None) for app in _engine_progs() for mode in MODES]
    runs.append(("msbfs", "hybrid", "bfloat16"))   # levels are exact in bf16
    for app, mode, wire in runs:
        eng = DistributedGABEngine(None, DistConfig(
            comm_mode=mode, wire_dtype=wire, device="cpu"))
        vals, hist = eng.run(_engine_progs()[app], tiles, plan.num_vertices,
                             outd, ind, plan.row_cap, max_supersteps=SS)
        out[(app, mode, wire)] = (vals, hist)
    return out


def _mesh_worker(rank, world, init_file, store_root, results):
    try:
        backend = init_process_group(rank, world, f"file://{init_file}",
                                     device="cpu")
        out = dict(backend=backend,
                   collectives=_collective_cases(rank, world),
                   engine=_engine_cases(store_root))
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def store_root(small_graph, tmp_path_factory):
    from repro.graphio import spe
    from repro.graphio.formats import TileStore as JTileStore

    nv, src, dst = small_graph
    root = str(tmp_path_factory.mktemp("mesh_store"))
    spe.preprocess_arrays(src, dst, None, nv, JTileStore(root),
                          tile_size=150)
    return root


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def launch(request, store_root):
    """One spawned gloo launch per world size: {rank: results}."""
    world = request.param
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(tempfile.mkdtemp(prefix="gloo_"), "init")
    procs = [ctx.Process(target=_mesh_worker,
                         args=(r, world, init_file, store_root, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, status, payload = results.get(timeout=240)
            assert status == "ok", f"rank {rank}:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        pytest.fail(f"world {world}: ranks {sorted(set(range(world)) - set(got))}"
                    " reported nothing")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    assert not any(p.is_alive() for p in procs)
    return world, got


def _events(hist):
    """A mesh run's history without its timings."""
    return [(h["superstep"], h["density"], h["branch"]) for h in hist]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


def test_gloo_is_the_cpu_backend(launch):
    _, got = launch
    assert {r["backend"] for r in got.values()} == {"gloo"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_collectives_exact_on_every_rank(launch, case):
    world, got = launch
    name, density, q, mode, cap, vdt, only0 = case
    old, new, updated, _ = _case_data(name, density, q, world, only0)
    res, dens, branch = got[0]["collectives"][name]
    nv_cells = updated.size
    capacity = cap or comm.sparse_capacity(nv_cells)
    assert dens == updated.sum() / nv_cells
    want_branch = ("dense" if mode == "dense"
                   or (mode == "hybrid" and dens >= comm.DENSITY_THRESHOLD)
                   else "sparse")
    if want_branch == "sparse" and capacity < nv_cells:
        owner = (np.arange(NV) * world) // NV
        per_rank = [int(updated[owner == r].sum()) for r in range(world)]
        # the guard: any rank past capacity sends the step dense
        if (mode == "sparse" or capacity < np.ceil(
                nv_cells * comm.DENSITY_THRESHOLD)) and max(per_rank) > capacity:
            want_branch = "dense"
    assert branch == want_branch
    sent = new
    if vdt is not None and branch == "sparse":
        sent = torch.from_numpy(new).to(getattr(torch, vdt)).float().numpy()
    want = np.where(updated, sent, old)
    assert np.array_equal(_bits(res), _bits(want))
    for r in range(1, world):
        r_res, r_dens, r_branch = got[r]["collectives"][name]
        assert np.array_equal(_bits(r_res), _bits(res))
        assert (r_dens, r_branch) == (dens, branch)


def test_guard_cases_take_the_branches_they_name(launch):
    _, got = launch
    c = got[0]["collectives"]
    assert c["guard-sparse"][2] == "dense"
    assert c["guard-hybrid"][2] == "dense"
    assert c["guard-hybrid-fits"][2] == "sparse"
    assert c["hybrid-d0.01"][2] == "sparse"


def _vmap_reference(fn, world, *arrays):
    """A reference collective under ``jax.vmap`` with one mapped index a
    rank (the ``axis_name`` stands in for the mesh axis)."""
    import jax

    return np.asarray(jax.vmap(fn, axis_name="i")(*arrays))


@pytest.mark.parametrize("mode", MODES)
def test_collectives_match_reference(launch, mode):
    from repro.core import comm as jcomm

    world, got = launch
    name = f"{mode}-d0.3"
    old, new, updated, owner = _case_data(name, 0.3, None, world, False)
    ins = [_local_inputs(old, new, updated, owner, r) for r in range(world)]
    stacked = [np.stack([x[k].numpy() for x in ins]) for k in range(3)]

    def ref(o, n, u):
        return jcomm.hybrid_broadcast(o, n, u, "i", mode=mode)[0]

    want = _vmap_reference(ref, world, *stacked)[0]
    res = got[0]["collectives"][name][0]
    # equal as numbers; the reference's +0.0-masked sum drops the sign of
    # an updated -0.0 in its dense branch, the port's -0.0 mask keeps it
    assert np.array_equal(res, want)
    neg_zero = updated & (new == 0) & np.signbit(new)
    assert neg_zero.any()
    assert np.signbit(res[neg_zero]).all()
    if got[0]["collectives"][name][2] == "dense":
        assert not np.signbit(want[neg_zero]).any()


@pytest.mark.parametrize("app", ["pagerank", "msbfs", "ppr"])
def test_mesh_engine_equals_out_of_core_engine(launch, store_root, app):
    world, got = launch
    ref = OutOfCoreEngine(TileStore(store_root), EngineConfig(
        device="cpu", num_servers=world, max_supersteps=SS)).run(
            _engine_progs()[app])
    modes = [(app, m, None) for m in MODES]
    if app == "msbfs":
        modes.append(("msbfs", "hybrid", "bfloat16"))
    for key in modes:
        vals, hist = got[0]["engine"][key]
        assert np.array_equal(_bits(vals), _bits(ref.values)), key
        assert len(hist) == ref.supersteps, key
        assert all(h["seconds"] > 0 for h in hist)
        for r in range(1, world):
            assert np.array_equal(_bits(got[r]["engine"][key][0]),
                                  _bits(vals)), (key, r)
            assert _events(got[r]["engine"][key][1]) == _events(hist)
    branches = {m: {h["branch"] for h in got[0]["engine"][(app, m, None)][1]}
                for m in MODES}
    assert branches["dense"] == {"dense"}
    if app == "msbfs":     # the late supersteps update few cells
        assert "sparse" in branches["hybrid"]


@pytest.mark.parametrize("app", ["pagerank", "msbfs", "ppr"])
def test_mesh_engine_matches_reference(launch, store_root, app):
    from repro.core import apps as japps
    from repro.core.engine import EngineConfig as JConfig
    from repro.core.engine import OutOfCoreEngine as JEngine
    from repro.graphio.formats import TileStore as JTileStore

    _, got = launch
    jprog = {"pagerank": japps.PageRank(),
             "msbfs": japps.MultiSourceBFS(sources=SEEDS),
             "ppr": japps.PersonalizedPageRank(seeds=SEEDS)}[app]
    want = JEngine(JTileStore(store_root), JConfig(
        num_servers=2, max_supersteps=SS)).run(jprog).values
    vals = got[0]["engine"][(app, "hybrid", None)][0]
    if app == "msbfs":
        assert np.array_equal(vals, want)
    else:
        np.testing.assert_allclose(vals, want, **SUM_TOL)


def test_backend_follows_the_device(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    assert init_process_group(0, 1, "file:///x", device="cpu") == "gloo"
    assert init_process_group(0, 1, "file:///x", device="cuda:0") == "nccl"
    assert init_process_group(0, 1, "file:///x", device="cuda",
                              backend="gloo") == "gloo"
    assert calls == ["gloo", "nccl", "gloo"]
    with pytest.raises(ValueError, match="no default backend"):
        init_process_group(0, 1, "file:///x", device="meta")


def test_mesh_engine_on_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    assert DistConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedGABEngine(None, DistConfig())
