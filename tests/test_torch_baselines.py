"""The port's baseline engines (``repro_torch.core.baselines``) against the
reference's (``repro.core.baselines``) and networkx, on the CPU.

Each of the four engines runs the port's programs on torch tensors
(``device="cpu"``); SSSP must equal the reference's values exactly,
PageRank within ``rtol=1e-5``, and the modelled network, disk-read and
disk-write bytes and the updated-vertex counts must equal the
reference's superstep by superstep.  The reference's two tests
(``tests/test_runtime.py``) are mirrored on the port.
"""
import numpy as np
import pytest

from repro_torch.core import apps as tapps
from repro_torch.core.baselines import ENGINES

NAMES = ["pregel+", "powergraph", "graphd", "chaos"]


def _engine(name, graph, tmp_path, **kw):
    nv, src, dst = graph
    extra = {}
    if name in ("graphd", "chaos"):
        tmp_path.mkdir(parents=True, exist_ok=True)
        extra["workdir"] = str(tmp_path)
    return ENGINES[name](src, dst, None, nv, num_servers=3, device="cpu",
                         **extra, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_baselines_match_networkx(name, small_graph, nx_pagerank, tmp_path):
    res = _engine(name, small_graph, tmp_path).run(
        tapps.PageRank(update_tol=1e-10), max_supersteps=150)
    ours = res.values / res.values.sum()
    assert np.abs(ours - nx_pagerank).max() < 1e-7, name


def test_baseline_cost_shapes(small_graph, tmp_path):
    """Table III qualitative shape: Chaos moves the most bytes; out-of-core
    engines do real disk I/O, in-memory ones none."""
    stats = {}
    for name in ENGINES:
        res = _engine(name, small_graph, tmp_path / name).run(
            tapps.PageRank(update_tol=1e-10), max_supersteps=3)
        stats[name] = res.history[1]
    assert stats["pregel+"].disk_read_bytes == 0
    assert stats["powergraph"].disk_read_bytes == 0
    assert stats["graphd"].disk_read_bytes > 0
    assert stats["chaos"].disk_read_bytes > 0
    assert stats["chaos"].network_bytes > stats["pregel+"].network_bytes


def _accounting(res):
    return [(h.superstep, h.network_bytes, h.disk_read_bytes,
             h.disk_write_bytes, h.updated_vertices) for h in res.history]


@pytest.mark.parametrize("app", ["pagerank", "sssp"])
@pytest.mark.parametrize("name", NAMES)
def test_baselines_match_reference(name, app, small_graph, tmp_path):
    """Values and every byte counter equal to the reference engine's on
    the same graph, superstep by superstep."""
    from repro.core import apps as japps
    from repro.core.baselines import ENGINES as JENGINES

    nv, src, dst = small_graph
    if app == "pagerank":
        progs = (japps.PageRank(update_tol=1e-10),
                 tapps.PageRank(update_tol=1e-10))
        steps = 12
    else:
        progs = japps.SSSP(source=3), tapps.SSSP(source=3)
        steps = 60
    kw = dict(num_servers=3)
    jextra = {"workdir": str(tmp_path / "ref")} \
        if name in ("graphd", "chaos") else {}
    if jextra:
        (tmp_path / "ref").mkdir()
    want = JENGINES[name](src, dst, None, nv, **kw, **jextra).run(
        progs[0], max_supersteps=steps)
    got = _engine(name, small_graph, tmp_path).run(progs[1],
                                                   max_supersteps=steps)
    assert _accounting(got) == _accounting(want)
    if app == "sssp":
        assert np.array_equal(got.values, np.asarray(want.values))
    else:
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   rtol=1e-5)
    assert got.name == want.name == name


def test_baseline_on_missing_card_raises(small_graph):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    nv, src, dst = small_graph
    with pytest.raises(RuntimeError, match="CUDA"):
        ENGINES["pregel+"](src, dst, None, nv)
