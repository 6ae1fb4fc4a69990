"""The port's block tuner (``repro_torch.roofline.kernel_tune``) and the
engine's live tuner knobs, on the CPU — the counterparts of the
reference's tuner tests (``tests/test_gab_fused.py``).

* ``pick_blocks`` is deterministic, feasible on the H100's shared memory
  and registers, never models worse than the static ``(256, 256)``, is
  capped at the tile's shape and falls back to the smallest legal pair
  on a degenerate budget; ``_stack_size`` falls as tile time grows.
* ``EngineConfig(kernel_autotune=True)`` equals the default-block run
  bit for bit, serial and pipelined, for every app, and equals the
  reference's autotuned run (``array_equal`` for the min/max apps and
  InDegree, ``rtol=1e-5, atol=1e-6`` for PageRank/PPR).
* ``kernel_blocks`` reaches every kernel call verbatim (a spy on
  ``kernels.ops``) in every engine mode; illegal blocks raise.
* ``--kernel-autotune`` prints the reference's line.

On the CPU the kernels' plain versions ignore the blocks, so the bit
identity of every block pair on the card is ``chip_smoke.py`` phase 17's
(and the numpy models' in ``test_torch_kernel_order.py``).
"""
import numpy as np
import pytest

from repro_torch.core import apps as tapps
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.graphio.formats import TileStore
from repro_torch.kernels import blocks as kblocks
from repro_torch.kernels import ops
from repro_torch.launch import graph as tgraph
from repro_torch.roofline import hw, kernel_tune

PR_TOL = dict(rtol=1e-5, atol=1e-6)
APPS = ("pagerank", "sssp", "wcc", "bfs", "indegree", "ppr", "msbfs",
        "landmarks")
EXACT = ("sssp", "wcc", "bfs", "indegree", "msbfs", "landmarks")


def _prog(pkg, app):
    return {"pagerank": lambda: pkg.PageRank(), "sssp": lambda: pkg.SSSP(),
            "wcc": lambda: pkg.WCC(), "bfs": lambda: pkg.BFS(),
            "indegree": lambda: pkg.InDegree(),
            "ppr": lambda: pkg.PersonalizedPageRank(seeds=(1, 7, 50)),
            "msbfs": lambda: pkg.MultiSourceBFS(sources=(0, 5, 40, 77)),
            "landmarks": lambda: pkg.LandmarkDistances(
                landmarks=(3, 9, 100, 200, 250, 11, 17, 29))}[app]()


def _run(store, prog, supersteps=10, **kw):
    eng = OutOfCoreEngine(TileStore(store.root), EngineConfig(
        num_servers=2, device="cpu", **kw))
    return eng.run(prog, max_supersteps=supersteps), eng


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def test_pick_blocks_deterministic_and_feasible():
    a = kernel_tune.pick_blocks("sum", 1, 1 << 20, 1 << 17)
    b = kernel_tune.pick_blocks("sum", 1, 1 << 20, 1 << 17)
    assert a == b
    assert a.block_e in kblocks.BLOCK_E and a.block_r in kblocks.BLOCK_R
    assert 1 <= a.stack_size <= 16
    assert a.predicted_s > 0 and a.edges_per_s > 0
    assert a.bound in ("memory", "compute")
    # one block's shared memory and registers fit the card
    assert a.smem_bytes <= hw.SMEM_PER_BLOCK
    assert a.blocks_per_sm >= 1
    assert a.blocks_per_sm * (a.smem_bytes + hw.SMEM_RESERVED_PER_BLOCK) \
        <= hw.SMEM_PER_SM
    assert a.blocks_per_sm * a.block_r * 64 <= hw.REGS_PER_SM
    assert a.blocks_per_sm * a.block_r <= hw.THREADS_PER_SM


@pytest.mark.parametrize("br", kblocks.BLOCK_R)
def test_every_row_block_fits_the_card(br):
    per_sm = kernel_tune.blocks_per_sm(br)
    assert per_sm * br == kernel_tune.RESIDENT_THREADS
    assert kernel_tune.smem_bytes(br) <= hw.SMEM_PER_BLOCK


def test_pick_blocks_never_model_worse_than_static():
    """The static (256, 256) is a candidate whenever it fits the tile,
    so the pick never predicts worse than it there."""
    checked = 0
    for combine in ("sum", "min"):
        for q in (1, 2, 8, 9, 32):
            for ec, rc in [(4096, 512), (65536, 2048), (512, 128),
                           (1 << 20, 1 << 17), (100, 60), (300, 200)]:
                if kernel_tune.STATIC_BLOCKS not in kernel_tune.candidates(
                        ec, rc):
                    continue
                pick = kernel_tune.pick_blocks(combine, q, ec, rc)
                static = kernel_tune.tile_cost(combine, q, ec, rc,
                                               *kernel_tune.STATIC_BLOCKS)
                assert pick.predicted_s <= static.predicted_s, \
                    (combine, q, ec, rc)
                checked += 1
    assert checked == 2 * 5 * 4


def test_pick_blocks_caps_at_tile_shape():
    """Blocks larger than the tile only pad: a tiny tile picks the
    smallest pair, and no candidate passes the cap."""
    assert kernel_tune.pick_blocks("sum", 1, 100, 60).blocks == (128, 128)
    assert kernel_tune.candidates(100, 60) == [(128, 128)]
    for be, br in kernel_tune.candidates(300, 200):
        assert be <= 384 and br <= 256
    assert len(kernel_tune.candidates(1 << 20, 1 << 17)) == \
        len(kblocks.BLOCK_E) * len(kblocks.BLOCK_R)


def test_stack_size_scales_inverse_with_tile_time():
    assert kernel_tune._stack_size(1e-6) == 16      # tiny tiles: batch hard
    assert kernel_tune._stack_size(1.0) == 1        # huge tiles: no batching
    sizes = [kernel_tune._stack_size(t)
             for t in np.geomspace(1e-7, 10.0, 40)]
    assert sizes == sorted(sizes, reverse=True)


def test_degenerate_budget_falls_back():
    c = kernel_tune.pick_blocks("min", 64, 4096, 2048, smem_budget=1024)
    assert c.blocks == (128, 128)


def test_pick_reads_only_the_card_table():
    """The pick depends on the table, not on a run-time measurement, and
    the table carries the card's figures, no TPU one."""
    a = kernel_tune.pick_blocks("min", 8, 1 << 20, 1 << 17)
    assert a == kernel_tune.pick_blocks("min", 8, 1 << 20, 1 << 17,
                                        bandwidth=hw.HBM_BW)
    for tpu_name in ("VMEM_BYTES", "MXU_ALIGN", "SUBLANES", "ICI_BW_PER_LINK",
                     "VPU_OPS", "PEAK_FLOPS_BF16", "GRID_STEP_OVERHEAD_S"):
        assert not hasattr(hw, tpu_name)
    assert hw.CARD in hw.MEASURED_ON and "W" in hw.MEASURED_ON
    assert hw.HBM_BW == 3.35e12 and hw.SMS == 132


def test_hub_size_follows_the_kernels():
    """hub_size mirrors seg_layout.cuh's hub_shift from block_e."""
    assert kernel_tune.hub_size(1 << 20, 256) == 256
    assert kernel_tune.hub_size(1 << 20, 128) == 128
    assert kernel_tune.hub_size(256 * 16385 + 1, 256) == 512
    assert kernel_tune.hub_size(1 << 26, 256) == 4096
    assert kernel_tune.hub_size(1 << 26, 2048) == 4096


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("app", APPS)
def test_engine_autotune_bit_identical(small_store, app, pipeline):
    """kernel_autotune changes blocks and the stack size only: the run
    equals the default blocks' bit for bit, serial and pipelined."""
    store, _, _ = small_store
    got, eng = _run(store, _prog(tapps, app), kernel_autotune=True,
                    pipeline=pipeline)
    want, _ = _run(store, _prog(tapps, app), pipeline=pipeline)
    c = eng.kernel_choice
    assert c is not None and c.block_e in kblocks.BLOCK_E
    assert np.array_equal(got.values, want.values)
    assert got.supersteps == want.supersteps
    if want.per_query_supersteps is not None:
        assert np.array_equal(got.per_query_supersteps,
                              want.per_query_supersteps)
    q = getattr(_prog(tapps, app), "num_queries", 1)
    assert eng._kernel_choices == {(_prog(tapps, app).combine, q): c}


@pytest.mark.parametrize("app", APPS)
def test_engine_autotune_matches_reference(small_store, app):
    """The port's autotuned run against the reference's autotuned run
    (Pallas interpret mode): exact for the min/max apps and InDegree,
    within the sum tolerance for PageRank/PPR."""
    from repro.core import apps as japps
    from repro.core.engine import EngineConfig as JConfig
    from repro.core.engine import OutOfCoreEngine as JEngine

    store, _, _ = small_store
    want = JEngine(store, JConfig(num_servers=2, kernel_autotune=True)).run(
        _prog(japps, app), max_supersteps=10)
    got, _ = _run(store, _prog(tapps, app), kernel_autotune=True)
    if app in EXACT:
        assert np.array_equal(got.values, np.asarray(want.values))
        assert got.supersteps == want.supersteps
    else:
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   **PR_TOL)


@pytest.mark.parametrize("mode", [
    dict(), dict(pipeline=True), dict(engine_mode="stacked"),
    dict(engine_mode="merged", tile_skipping=False),
    dict(seg_impl="segment"), dict(vertex_memory_budget=1 << 12),
    dict(kernel_autotune=True)])
def test_explicit_kernel_blocks_pass_through(small_store, monkeypatch, mode):
    """cfg.kernel_blocks reaches every kernel call verbatim, in every
    mode, and wins over the tuner (which is never consulted)."""
    store, _, _ = small_store
    want, _ = _run(store, tapps.BFS(), supersteps=3)
    seen = []
    real_fused, real_seg = ops.gab_fused, ops.segment_reduce

    def fused(*a, blocks=None, **kw):
        seen.append(("fused", blocks))
        return real_fused(*a, blocks=blocks, **kw)

    def seg(*a, blocks=None, **kw):
        seen.append(("segment", blocks))
        return real_seg(*a, blocks=blocks, **kw)

    monkeypatch.setattr(ops, "gab_fused", fused)
    monkeypatch.setattr(ops, "segment_reduce", seg)
    got, eng = _run(store, tapps.BFS(), supersteps=3,
                    kernel_blocks=(1024, 512), **mode)
    assert np.array_equal(got.values, want.values)
    assert seen and all(b == (1024, 512) for _, b in seen)
    assert eng.kernel_choice is None
    kinds = {k for k, _ in seen}
    assert kinds == ({"segment"} if mode.get("seg_impl") == "segment"
                     or mode.get("engine_mode") == "merged" else {"fused"})


@pytest.mark.parametrize("blocks", [(300, 256), (256, 64), (4096, 256),
                                    (256,), "256x256", (256, 1024)])
def test_illegal_blocks_raise(small_store, blocks):
    import torch

    store, _, _ = small_store
    legal = (r"block_e must be one of \(128, 256, 512, 1024, 2048\) and "
             r"block_r one of \(128, 256, 512\)")
    with pytest.raises(ValueError, match=legal):
        OutOfCoreEngine(TileStore(store.root), EngineConfig(
            device="cpu", kernel_blocks=blocks))
    c = torch.ones(4)
    d = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=legal):
        ops.segment_reduce(c, d, 4, "sum", blocks=blocks)
    spec = tapps.BFS().fused_spec()
    with pytest.raises(ValueError, match=legal):
        ops.gab_fused(spec, c, None, None, d, c, None, 4, 4, blocks=blocks)


def test_cli_prints_the_autotune_line(tmp_path, capsys):
    res = tgraph.main(["--app", "pagerank", "--vertices", "2000", "--edges",
                       "20000", "--tile-size", "4096", "--servers", "2",
                       "--supersteps", "3", "--kernel-autotune",
                       "--store", str(tmp_path / "s"), "--device", "cpu"])
    assert res.supersteps == 3
    text = capsys.readouterr().out
    plan = TileStore(str(tmp_path / "s")).load_plan()
    c = kernel_tune.pick_blocks("sum", 1, plan.edge_cap, plan.row_cap)
    assert (f"  kernel autotune [sum, Q=1]: BE={c.block_e} BR={c.block_r} "
            f"stack={c.stack_size} ({c.bound}-bound, ceiling "
            f"{c.edges_per_s:.2e} edges/s)") in text.splitlines()


def test_serve_cli_prints_the_autotune_lines(tmp_path, capsys):
    tgraph.main(["--serve", "--device", "cpu", "--vertices", "2000",
                 "--edges", "20000", "--tile-size", "4096", "--servers", "1",
                 "--serve-apps", "msbfs,landmarks", "--serve-requests", "6",
                 "--kernel-autotune", "--store", str(tmp_path / "s")])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "kernel autotune [" in ln]
    assert lines and all("BE=" in ln and "stack=" in ln for ln in lines)
    assert any(ln.startswith("  msbfs kernel autotune [min, Q=")
               for ln in lines)
