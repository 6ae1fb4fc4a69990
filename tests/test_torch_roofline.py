"""The port's roofline tools (``repro_torch.roofline``) against the JAX
package's (``tests/test_roofline.py``'s cases): the term math, the model
FLOPs, loops counted once an iteration, the collective bytes, the DTensor
counting trap, and the counting rules of ``hlo_cost``."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.roofline import analysis as pa
from repro_torch.roofline import hlo_cost as pc
from repro_torch.roofline import hw as phw

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _subprocess(code: str) -> dict:
    """Runs ``code`` in a fresh interpreter (a fake process group must not
    share a process with other tests); its last line of output is JSON."""
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --- the term math ---------------------------------------------------------

ROOFLINE_CASES = [
    dict(flops=3e14, hbm_bytes=4e11, coll_bytes=0, n_chips=4,
         model_flops_total=5e14),
    dict(flops=1e12, hbm_bytes=9e12, coll_bytes=2e9, n_chips=256,
         model_flops_total=1e14, hbm_bytes_fused=3e12),
    dict(flops=5e11, hbm_bytes=1e10, coll_bytes=8e11, n_chips=512,
         model_flops_total=2e16, links=2),
    dict(flops=0.0, hbm_bytes=0.0, coll_bytes=0.0, n_chips=1,
         model_flops_total=0.0),
]


@pytest.mark.parametrize("case", ROOFLINE_CASES)
def test_roofline_terms_math(case, monkeypatch):
    """With the port's figures set to the reference's (TPU v5e), every term
    is the reference's; with the H100's own, a second at the peak."""
    from repro.roofline import analysis as ra
    from repro.roofline import hw as rhw

    monkeypatch.setattr(phw, "PEAK_FLOPS_BF16", rhw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(phw, "HBM_BW", rhw.HBM_BW)
    monkeypatch.setattr(phw, "LINK_BW", rhw.ICI_BW_PER_LINK)
    assert pa.roofline(**case).as_dict() == ra.roofline(**case).as_dict()
    monkeypatch.undo()

    t = pa.roofline(flops=phw.PEAK_FLOPS_BF16, hbm_bytes=phw.HBM_BW / 2,
                    coll_bytes=phw.LINK_BW / 4, n_chips=4,
                    model_flops_total=phw.PEAK_FLOPS_BF16)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(0.25)
    assert t.bottleneck == "compute"
    assert t.mfu_bound == pytest.approx(0.25)   # model/(4 chips * peak * 1s)


def test_hw_holds_the_h100_figures():
    """The roofline's datasheet figures (roofline/hw.py), none of the TPU's."""
    assert phw.PEAK_FLOPS_BF16 == 989.4e12
    assert phw.PEAK_FLOPS_F32 == phw.F32_FLOPS == 67e12
    assert phw.LINK_BW == 450e9
    assert phw.HBM_BYTES == 80 * 1024 ** 3
    assert phw.HBM_BW == 3.35e12
    for name in ("ICI_BW_PER_LINK", "VPU_OPS", "GRID_STEP_OVERHEAD_S",
                 "HOST_DISPATCH_S", "VMEM_BYTES"):
        assert not hasattr(phw, name)


@pytest.mark.parametrize("kind,n,tokens,embed", [
    ("train", 10, 100, 0), ("prefill", 10, 100, 0), ("train", 10, 100, 4),
    ("decode", 1720837120, 128, 311164928),
    ("train", 36469708800, 1048576, 100663296)])
def test_model_flops(kind, n, tokens, embed):
    from repro.roofline import analysis as ra

    assert pa.model_flops(kind, n, tokens, embed) == \
        ra.model_flops(kind, n, tokens, embed)
    assert pa.model_flops("train", 10, 100) == 6000


def test_no_xla_cost_analysis():
    """The reference's cost_analysis_terms reads XLA's cost_analysis, which
    counts a loop body once; the port compiles nothing and has none."""
    assert not hasattr(pa, "cost_analysis_terms")


# --- loops: each iteration counted as it runs --------------------------------

def _ref_dot_flops(n: int) -> float:
    import jax
    import jax.numpy as jnp
    from repro.roofline import hlo_cost

    x = jax.ShapeDtypeStruct((n, n), jnp.float32)
    return hlo_cost.analyze(
        jax.jit(lambda a, b: a @ b).lower(x, x).compile().as_text()).flops


def test_scan_flops_multiplied():
    x, w = torch.randn(256, 256), torch.randn(256, 256)

    def scan10(c, w):
        for _ in range(10):
            c = c @ w
        return c

    f1 = pc.analyze(lambda a, b: a @ b, x, w).flops
    assert f1 == 2 * 256 ** 3 == _ref_dot_flops(256)
    assert pc.analyze(scan10, x, w).flops == 10 * f1


def test_nested_scan_multiplied():
    x, w = torch.randn(128, 128), torch.randn(128, 128)

    def nested(c, w):
        for _ in range(4):
            for _ in range(3):
                c = c @ w
        return c

    c = pc.analyze(nested, x, w)
    assert c.flops == 12 * 2 * 128 ** 3
    assert c.unknown_trip_loops == 0


def test_xla_cost_analysis_undercounts_loops_motivation():
    """The reference's motivation: XLA counts the scan's body once, its
    hlo_cost ten times; the port counts the ten iterations as they run."""
    import jax
    import jax.numpy as jnp
    from repro.roofline import analysis as ra
    from repro.roofline import hlo_cost

    def scan10(x, w):
        def body(c, _):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, None, length=10)
        return y

    s = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    comp = jax.jit(scan10).lower(s, s).compile()
    xla_flops, _ = ra.cost_analysis_terms(comp)
    ref = hlo_cost.analyze(comp.as_text()).flops

    def loop10(c, w):
        for _ in range(10):
            c = c @ w
        return c

    ours = pc.analyze(loop10, torch.randn(128, 128),
                      torch.randn(128, 128)).flops
    assert ours >= 9 * xla_flops
    assert ours == pytest.approx(ref, rel=1e-6)


def test_conditional_takes_max_branch():
    """The reference takes the larger branch of a conditional; eager
    execution counts the branch it takes."""
    import jax
    import jax.numpy as jnp
    from repro.roofline import hlo_cost

    def f(x, pred):
        return jax.lax.cond(pred, lambda a: a @ a, lambda a: a + 1.0, x)

    x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    p = jax.ShapeDtypeStruct((), jnp.bool_)
    ref = hlo_cost.analyze(jax.jit(f).lower(x, p).compile().as_text())
    assert ref.flops >= 2 * 128 ** 3 * 0.95      # matmul branch counted

    def g(a, pred):
        return a @ a if pred else a + 1.0

    t = torch.randn(128, 128)
    assert pc.analyze(g, t, True).flops == 2 * 128 ** 3
    assert pc.analyze(g, t, False).flops == 128 * 128


# --- collectives and the DTensor trap (fake process groups) ----------------

def test_collective_bytes_parse():
    """An all-reduce of f32[1024] and an all-gather to f32[8192] over a fake
    group of 8: operand bytes, not result bytes — the reference's numbers
    on the same program's HLO."""
    from repro.roofline import analysis as ra

    hlo = """
HloModule test
ENTRY %main (p: f32[1024]) -> f32[1024] {
  %p = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(%p), to_apply=%add
  ROOT %ag = f32[8192]{0} all-gather(%ar), dimensions={0}
}
"""
    ref = ra.collective_bytes(hlo)
    got = _subprocess("""
        import json
        import torch, torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.roofline import analysis, hlo_cost
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        try:
            group = dist.group.WORLD
            def f(p):
                ar = funcol.all_reduce(p, "sum", group)
                return funcol.all_gather_tensor(ar, 0, group)
            r = hlo_cost.run(f, torch.zeros(1024))
            out = analysis.collective_bytes(r.records)
            out["shape"] = list(r.result.shape)
            out["coll_bytes"] = r.cost.coll_bytes
            out["coll_by_kind"] = r.cost.coll_by_kind
        finally:
            dist.destroy_process_group()
        print(json.dumps(out))
    """)
    assert got["shape"] == [8192]
    assert got["all-reduce"] == ref["all-reduce"] == 4096
    assert got["all-gather"] == ref["all-gather"] == 4096
    assert got["total"] == ref["total"] == 8192
    assert got["op_counts"] == ref["op_counts"] == {"all-reduce": 1,
                                                    "all-gather": 1}
    assert got["coll_bytes"] == 8192
    assert got["coll_by_kind"] == {"all-reduce": 4096, "all-gather": 4096}


def test_dtensor_matmul_counts_the_local_shard_only():
    """Under DTensor a dispatch mode sees the global op and the local one;
    the count is the local shard's: [4096, 2048] @ [2048, 8192] sharded
    (Shard(0), Replicate()) x (Replicate(), Shard(1)) on a (16, 16) mesh
    of a fake group of 256 is a [256, 2048] @ [2048, 512] product a
    device, not the global 2*4096*2048*8192 (and not both)."""
    got = _subprocess("""
        import json
        import torch, torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.roofline import hlo_cost
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=256)
        try:
            mesh = init_device_mesh("cpu", (16, 16),
                                    mesh_dim_names=("data", "model"))
            with FakeTensorMode():
                a = distribute_tensor(torch.empty(4096, 2048), mesh,
                                      [Shard(0), Replicate()])
                b = distribute_tensor(torch.empty(2048, 8192), mesh,
                                      [Replicate(), Shard(1)])
                r = hlo_cost.run(lambda x, y: x @ y, a, b)
                g = hlo_cost.run(lambda x: x.redistribute(
                    mesh, [Replicate(), Replicate()]), r.result)
            out = dict(flops=r.cost.flops,
                       local=list(r.result.to_local().shape),
                       ops=[x.name for x in r.records],
                       coll=g.cost.coll_by_kind, mem=r.memory.as_dict())
        finally:
            dist.destroy_process_group()
        print(json.dumps(out))
    """)
    assert got["local"] == [256, 512]
    assert got["flops"] == 2 * 256 * 512 * 2048
    assert got["ops"].count("aten.mm.default") == 1
    # gathering the [256, 512] float32 shards: an all-gather a mesh dim,
    # each of its local operand (524,288 bytes, then 16x that)
    assert got["coll"] == {"all-gather": 524288 + 16 * 524288}
    assert got["mem"]["argument_bytes"] == (256 * 2048 + 2048 * 512) * 4
    assert got["mem"]["output_bytes"] == 256 * 512 * 4


# --- the counting rules -----------------------------------------------------

def test_counting_rules():
    """Each class of op by the module docstring's rules."""
    x = torch.randn(64, 32)
    idx = torch.arange(16, dtype=torch.int64)
    table = torch.randn(100, 32)

    def cost_of(fn, *a):
        r = pc.run(fn, *a)
        return r.cost, [pc.op_kind(o.name) for o in r.records]

    c, kinds = cost_of(lambda a: a.view(32, 64).t().detach(), x)
    assert c.flops == c.bytes == c.bytes_fused == 0 and kinds == []
    c, kinds = cost_of(lambda a: torch.exp(a) + 1.0, x)
    assert kinds == ["elementwise", "elementwise"]
    assert c.flops == 2 * 64 * 32
    assert c.bytes == 2 * 2 * 64 * 32 * 4 and c.bytes_fused == 0
    c, kinds = cost_of(lambda a: a.sum(0), x)
    assert kinds == ["reduce"] and c.flops == 64 * 32 * 4 / 4.0
    assert c.bytes == (64 * 32 + 32) * 4 and c.bytes_fused == 0
    c, kinds = cost_of(lambda a: a.t().contiguous(), x)
    assert kinds == ["move"] and c.bytes == 2 * 64 * 32 * 4
    assert c.flops == c.bytes_fused == 0
    c, kinds = cost_of(lambda t, i: torch.nn.functional.embedding(i, t),
                       table, idx)
    assert kinds == ["gather"]
    assert c.bytes == c.bytes_fused == 2 * 16 * 32 * 4 + 16 * 8
    c, kinds = cost_of(lambda a, i, v: a.index_add(0, i, v), table, idx,
                       torch.randn(16, 32))
    assert kinds == ["scatter"] and c.flops == 100 * 32
    assert c.bytes == 2 * 100 * 32 * 4 + 16 * 8
    cache = torch.zeros(8, 128, 32)
    c, kinds = cost_of(lambda c, v: c[:, 5].copy_(v), cache,
                       torch.randn(8, 32))
    assert kinds == ["update"] and c.bytes == c.bytes_fused == 2 * 8 * 32 * 4
    c, kinds = cost_of(lambda a, b: torch.addmm(b[0], a, a.t()), x,
                       torch.randn(1, 64))
    assert kinds == ["dot"] and c.flops == 2 * 64 * 64 * 32
    assert c.bytes == c.bytes_fused == (64 + 64 * 32 + 64 * 64) * 4 \
        + 64 * 32 * 4


def test_record_recounts_to_the_same_cost():
    """A record saved as JSON lists recounts to the cost of the run."""
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.GELU(),
                                torch.nn.Linear(64, 8))
    x = torch.randn(16, 32)

    def step(m, x):
        loss = m(x).square().mean()
        loss.backward()
        return loss

    r = pc.run(step, model, x)
    saved = json.loads(json.dumps([o.as_list() for o in r.records]))
    assert pc.count(saved) == r.cost
    # the products: forward, both gradients of the last layer, the weight
    # gradient of the first (its input needs none)
    dots = pc.count([o for o in r.records if pc.op_kind(o.name) == "dot"])
    assert dots.flops == 2 * 16 * (32 * 64 + 64 * 8) \
        + 2 * 2 * 16 * 64 * 8 + 2 * 16 * 32 * 64
    assert r.cost.unknown_trip_loops == 0


def test_attribute_groups_by_module():
    """The counts grouped by nn.Module path, biggest first at the card's
    figures."""
    model = torch.nn.Sequential(torch.nn.Linear(256, 1024),
                                torch.nn.Linear(1024, 4))
    x = torch.randn(64, 256)
    rows = pc.attribute(lambda m, a: m(a), model, x, depth=2, top_k=5)
    tags = [t for t, _, _ in rows]
    assert tags[0] == "Sequential.0"
    by = {t: (f, b) for t, f, b in rows}
    # addmm: its product's FLOPs (the bias add rides along)
    assert by["Sequential.0"][0] == 2 * 64 * 256 * 1024
    assert by["Sequential.1"][0] == 2 * 64 * 1024 * 4
    recs = pc.run(lambda m, a: m(a), model, x).records
    assert pc.attribute(recs, depth=2, top_k=5) == rows


def test_memory_tracks_live_storages():
    """Arguments, results and the temporaries' peak, per storage."""
    a = torch.randn(1024)            # 4 KiB

    def f(a):
        t1 = a * 2.0                 # 4 KiB temporary
        t2 = t1 + 1.0                # 4 KiB more, t1 still alive
        del t1
        return t2.view(32, 32), a    # the argument returned as it is

    r = pc.run(f, a)
    m = r.memory.as_dict()
    assert m["argument_bytes"] == 4096
    assert m["output_bytes"] == 8192           # t2 and a
    assert r.memory.peak_new_bytes == 8192
    assert m["temp_bytes"] == 4096             # t1 at the peak
    assert m["peak_bytes_estimate"] == 4096 + 8192 + 4096


def test_fake_and_real_counts_agree():
    """The same function on fake tensors counts what it counts on real
    ones (the dry run's premise)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def f(a, b):
        h = torch.nn.functional.silu(a @ b)
        return torch.softmax(h.float(), -1).sum()

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((48, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 40)).astype(np.float32))
    real = pc.run(f, a, b)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fa, fb = mode.from_tensor(a), mode.from_tensor(b)
        fake = pc.run(f, fa, fb)
    assert fake.cost == real.cost
    assert [o.as_list() for o in fake.records] == \
        [o.as_list() for o in real.records]
    assert fake.memory == real.memory
