"""The port's graph I/O against the JAX package's: SPE writes the same
bytes, and each package's TileStore reads the other's stores."""
import json
import os

import numpy as np
import pytest

from repro.graphio import spe as jspe
from repro.graphio.formats import TileStore as JTileStore
from repro_torch.core.cache import EdgeCache
from repro_torch.graphio import spe as tspe
from repro_torch.graphio.formats import TileStore as TTileStore


def _edges(weighted, seed=11):
    rng = np.random.default_rng(seed)
    nv, ne = 500, 4000
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    val = rng.uniform(0.1, 10.0, ne).astype(np.float32) if weighted else None
    return nv, src, dst, val


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.mark.parametrize("weighted,num_intervals,disk_mode", [
    (False, 0, 1), (True, 0, 3), (False, 4, 2)])
def test_spe_writes_identical_store(tmp_path, weighted, num_intervals,
                                    disk_mode):
    _check_identical_store(tmp_path, weighted, num_intervals, disk_mode)


@pytest.mark.parametrize("weighted,num_intervals,disk_mode,dedup", [
    (False, 4, 1, False), (True, 0, 3, True)])
def test_spe_threaded_writes_identical_store(tmp_path, weighted,
                                             num_intervals, disk_mode, dedup):
    """Tiles built on a thread pool and written in order: the reference's
    bytes still."""
    _check_identical_store(tmp_path, weighted, num_intervals, disk_mode,
                           threads=3, dedup=dedup)


def _check_identical_store(tmp_path, weighted, num_intervals, disk_mode,
                           threads=1, dedup=False):
    nv, src, dst, val = _edges(weighted)
    if dedup:
        src, dst = np.concatenate([src, src[:500]]), np.concatenate(
            [dst, dst[:500]])
        val = None if val is None else np.concatenate([val, val[:500]])
    jstore = JTileStore(str(tmp_path / "ref"), disk_mode=disk_mode)
    tstore = TTileStore(str(tmp_path / "port"), disk_mode=disk_mode)
    kw = dict(tile_size=300, num_intervals=num_intervals, dedup=dedup)
    jplan = jspe.preprocess_arrays(src, dst, val, nv, jstore, **kw)
    tplan = tspe.preprocess_arrays(src, dst, val, nv, tstore,
                                   threads=threads, **kw)
    assert jplan.to_dict() == tplan.to_dict()
    jfiles, tfiles = _files(jstore.root), _files(tstore.root)
    assert sorted(jfiles) == sorted(tfiles)
    assert any(k.startswith("tiles") for k in tfiles)
    for rel in jfiles:
        if rel == "degrees.npz":
            continue   # a zip archive: its member timestamps differ
        with open(jfiles[rel], "rb") as fj, open(tfiles[rel], "rb") as ft:
            assert fj.read() == ft.read(), rel
    for a, b in zip(jstore.load_degrees(), tstore.load_degrees()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("disk_mode", [1, 4])
def test_port_reads_reference_store(tmp_path, disk_mode):
    nv, src, dst, val = _edges(True, seed=3)
    jstore = JTileStore(str(tmp_path / "ref"), disk_mode=disk_mode)
    jplan = jspe.preprocess_arrays(src, dst, val, nv, jstore, tile_size=250)
    tstore = TTileStore(jstore.root)
    tplan = tstore.load_plan()
    assert tstore.disk_mode == disk_mode
    assert json.dumps(tplan.to_dict()) == json.dumps(jplan.to_dict())
    cache = EdgeCache(tstore, 1 << 20, mode=2)
    for t in range(tplan.num_tiles):
        want = jstore.read_tile(t)
        for got in (tstore.read_tile(t), cache.get(t)):
            got.validate()
            assert got.meta.to_dict() == want.meta.to_dict()
            for name in ("src", "dst_local", "val", "row_ptr"):
                assert np.array_equal(getattr(got, name), getattr(want, name))
    assert tstore.fingerprint() == jstore.fingerprint()


def test_reference_reads_port_store(tmp_path):
    nv, src, dst, val = _edges(False, seed=5)
    tstore = TTileStore(str(tmp_path / "port"), disk_mode=3)
    tplan = tspe.preprocess_arrays(src, dst, val, nv, tstore, tile_size=200)
    jstore = JTileStore(tstore.root)
    assert jstore.load_plan().to_dict() == tplan.to_dict()
    for t in range(tplan.num_tiles):
        got, want = jstore.read_tile(t), tstore.read_tile(t)
        assert np.array_equal(got.src, want.src)
        assert np.array_equal(got.dst_local, want.dst_local)


@pytest.mark.parametrize("weighted,threads", [(False, 3), (True, 4)])
def test_rmat_edges_threaded_equals_reference(weighted, threads):
    """The port's R-MAT drawn by a thread pool, each chunk from the seed's
    PCG64 advanced past the chunks before it, equals the reference's serial
    stream chunk for chunk (a partial last chunk included)."""
    from repro.graphio import synth as jsynth
    from repro_torch.graphio import synth as tsynth

    kw = dict(num_vertices=1000, num_edges=10000, seed=5, weighted=weighted,
              chunk=999)
    want = list(jsynth.rmat_edges(**kw))
    got = list(tsynth.rmat_edges(threads=threads, **kw))
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None and b is None) or np.array_equal(a, b)
