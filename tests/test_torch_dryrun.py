"""The port's dry run, perf runner and report tools
(``repro_torch.launch.{dryrun,perf,report,compare}``) against the JAX
package's: parameter counts and model FLOPs of every cell at full width,
the counted FLOPs and memory of reduced cells against the reference's HLO
cost and memory analysis, cells on a fake mesh, the remat ratio, the
tables, and ``--reanalyze``."""
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import registry as pregistry
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.launch import dryrun
from repro_torch.launch import perf as pperf
from repro_torch.launch import report as preport

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's result keys (repro/launch/dryrun.py:138-153) and its
# memory_analysis keys (:45-55)
REF_KEYS = {"arch", "cell", "mesh", "status", "n_chips", "params",
            "active_params", "lower_s", "compile_s", "memory", "collectives",
            "collective_ops", "unknown_trip_loops", "xla_cost", "roofline",
            "run_config"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "generated_code_bytes", "peak_bytes_estimate"}

# the counted FLOPs of a reduced prefill against the reference's hlo_cost
# of the same jitted prefill: 24,052,448 against 24,073,703 (-0.088 %),
# elementwise ops counted on aten ops where XLA has simplified and fused
# them; the bytes, 8,969,728 against 7,550,510 (+18.8 %), are op
# boundaries where XLA's are fusion boundaries (ROADMAP C)
PREFILL_FLOPS_RTOL = 0.01
PREFILL_BYTES_RATIO = (0.75, 1.35)


def _ref_cell(arch, cell_name, reduced=False, batch=None, seq=None):
    """The reference's (cfg, cell, run, model, parameter shapes) as its
    run_cell makes them (256 chips)."""
    import jax
    from repro.configs import registry
    from repro.models.model_zoo import build_model

    cell = SHAPE_CELLS[cell_name]
    if batch or seq:
        cell = dataclasses.replace(cell, global_batch=batch, seq_len=seq)
    cfg = registry.get_config(arch, reduced=reduced)
    run = registry.default_run_config(arch, cell, 256 if not batch else 1)
    model = build_model(cfg, run)
    pshapes = jax.eval_shape(model.init, jax.random.key(0))
    return cfg, cell, run, model, pshapes


@pytest.mark.parametrize("arch", pregistry.ARCH_IDS)
def test_params_and_model_flops_equal_reference(arch):
    """Every cell at full width: the runnable set, params, active_params
    and model_flops_total are the reference's (jax.eval_shape of its init,
    its param_count / active_param_count, its model_flops)."""
    from repro.configs import registry
    from repro.models.model_zoo import active_param_count, param_count
    from repro.roofline import analysis as ra

    for cell_name, cell in SHAPE_CELLS.items():
        assert pregistry.cell_runnable(arch, cell_name) == \
            registry.cell_runnable(arch, cell_name)
        if not registry.cell_runnable(arch, cell_name)[0]:
            res = dryrun.run_cell(arch, cell_name, "single", device="cpu")
            assert res["status"] == "skipped"
            continue
        cfg, cell, run, model, pshapes = _ref_cell(arch, cell_name)
        n_active = active_param_count(cfg, pshapes)
        embed_p = cfg.vocab_size * cfg.d_model
        tokens = cell.global_batch * (1 if cell.kind == "decode"
                                      else cell.seq_len)
        want = {"params": param_count(pshapes), "active_params": n_active,
                "model_flops_total": ra.model_flops(cell.kind, n_active,
                                                    tokens, embed_p)}
        assert dryrun.cell_summary(arch, cell_name) == want, cell_name


def test_prefill_flops_against_reference():
    """Reduced qwen3-1.7b prefill, batch 2 x 64, one device: the counted
    FLOPs within PREFILL_FLOPS_RTOL of the reference's hlo_cost of its
    jitted prefill, the bytes within PREFILL_BYTES_RATIO."""
    from repro.configs import registry
    from repro.roofline import hlo_cost
    from repro.serve import serve_step

    cfg, cell, run, model, pshapes = _ref_cell(
        "qwen3-1.7b", "prefill_32k", reduced=True, batch=2, seq=64)
    fns = serve_step.build_serve_fns(cfg, run, mesh=None, max_len=64,
                                     batch=2)
    import jax
    cshapes = jax.eval_shape(fns["init_cache"])
    ref = hlo_cost.analyze(fns["prefill"].lower(
        pshapes, cshapes, registry.input_specs(cfg, cell))
        .compile().as_text())

    res = dryrun.run_cell("qwen3-1.7b", "prefill_32k", "one", device="cpu",
                          reduced=True, batch=2, seq=64)
    rf = res["roofline"]
    assert res["status"] == "ok" and res["n_chips"] == 1
    assert rf["flops"] == pytest.approx(ref.flops, rel=PREFILL_FLOPS_RTOL)
    lo, hi = PREFILL_BYTES_RATIO
    assert lo <= rf["hbm_bytes"] / ref.bytes <= hi
    assert res["collectives"] == {} and rf["coll_bytes"] == 0
    assert res["unknown_trip_loops"] == 0
    assert rf["model_flops_total"] == 2.0 * (
        res["active_params"] - cfg.vocab_size * cfg.d_model) * 2 * 64


def test_train_memory_against_reference():
    """Reduced qwen3-1.7b train, batch 4 x 32, one device: the argument
    bytes are the reference's memory_analysis; its output bytes add the
    output tuple's index table (8 bytes a leaf) to the port's; the
    temporaries differ by design (live storages against XLA's buffer
    assignment) and are only recorded."""
    import jax
    from repro.configs import registry
    from repro.train import train_step as ts

    cfg, cell, run, model, _ = _ref_cell("qwen3-1.7b", "train_4k",
                                         reduced=True, batch=4, seq=32)
    step, init_state, _ = ts.build_train_step(cfg, run, mesh=None)
    st = jax.eval_shape(init_state, jax.random.key(0))
    specs = registry.input_specs(cfg, cell)
    ma = step.lower(st, specs).compile().memory_analysis()
    n_out = len(jax.tree_util.tree_leaves(jax.eval_shape(step, st, specs)))

    res = dryrun.run_cell("qwen3-1.7b", "train_4k", "one", device="cpu",
                          reduced=True, batch=4, seq=32)
    mem = res["memory"]
    assert set(mem) == REF_MEMORY_KEYS
    assert mem["argument_bytes"] == ma.argument_size_in_bytes
    assert mem["output_bytes"] + 8 * n_out == ma.output_size_in_bytes
    assert mem["temp_bytes"] > 0
    assert mem["peak_bytes_estimate"] == (mem["argument_bytes"]
                                          + mem["output_bytes"]
                                          + mem["temp_bytes"])


def test_run_cell_on_a_fake_mesh():
    """Reduced qwen3-1.7b and granite-moe train steps and an rwkv6 decode
    on a (2, 2) mesh of a fake group of 4, in a subprocess: status ok, the
    reference's keys, collective bytes counted; the group is left after
    each cell and refused beside a live one."""
    code = textwrap.dedent("""
        import json, sys, tempfile
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import dryrun
        from repro_torch.roofline import hlo_cost
        dryrun.RESULTS_DIR = tempfile.mkdtemp()
        out = []
        for arch, cell in (("qwen3-1.7b", "train_4k"),
                           ("granite-moe-1b-a400m", "train_4k"),
                           ("rwkv6-1.6b", "decode_32k")):
            res = dryrun.run_cell(arch, cell, "single", device="cpu",
                                  reduced=True, mesh_shape=(2, 2), batch=4,
                                  seq=32, save=True)
            res["initialized_after"] = dist.is_initialized()
            # gathers and scatters of a whole-vocab block (512, the
            # reduced vocab: the loss's target read and its backward)
            res["whole_vocab_ops"] = sorted({
                r[0] for r in dryrun.load_record(arch, cell, "single")
                if hlo_cost.op_kind(r[0]) in ("gather", "scatter")
                and any(len(o[0]) >= 3 and o[0][-1] == 512 for o in r[3])})
            out.append(res)
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=2)
        try:
            dryrun.run_cell("qwen3-1.7b", "decode_32k", "single",
                            device="cpu", reduced=True, mesh_shape=(2, 2),
                            batch=4, seq=32)
            refused = False
        except RuntimeError as e:
            refused = "already initialised" in str(e)
        dist.destroy_process_group()
        print(json.dumps(dict(cells=out, refused=refused)))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["refused"]
    # the loss reads the target from each rank's shard of the vocab
    # (sharding.gather_last): no gather or scatter of the train steps
    # touches a [B, S, V] block of the whole vocab
    assert got["cells"][0]["whole_vocab_ops"] == []
    assert got["cells"][1]["whole_vocab_ops"] == []
    from repro.roofline.analysis import RooflineTerms

    for res in got["cells"]:
        what = (res["arch"], res["cell"])
        assert res["status"] == "ok", what
        assert REF_KEYS <= set(res), what
        assert set(res["memory"]) == REF_MEMORY_KEYS
        assert set(res["roofline"]) == {
            f.name for f in dataclasses.fields(RooflineTerms)}
        assert res["n_chips"] == 4 and not res["initialized_after"]
        rf = res["roofline"]
        assert rf["coll_bytes"] > 0, what
        assert rf["coll_bytes"] == sum(res["collectives"].values())
        assert set(res["collectives"]) <= {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}
        assert sum(res["collective_ops"].values()) > 0
        assert rf["flops"] > 0 and rf["hbm_bytes"] > 0
        assert res["memory"]["argument_bytes"] > 0


def test_perf_remat_costs_an_extra_forward(tmp_path, monkeypatch):
    """``--set remat=none`` against the default ``block`` on a reduced
    train cell of 4 x 128 tokens: the remat's recomputed forward puts the
    FLOPs up by a ratio between 1.2 and 1.4 (measured 1.2173, the
    reference's hlo_cost 1.2197; the blocks' 4/3 diluted by the loss head
    and the optimizer, which are not rematerialised), within 1 % of the
    reference's ratio."""
    import jax
    from repro.configs import registry
    from repro.roofline import hlo_cost
    from repro.train import train_step as ts

    ref = {}
    for remat in ("block", "none"):
        cfg, cell, run, _, _ = _ref_cell("qwen3-1.7b", "train_4k",
                                         reduced=True, batch=4, seq=128)
        step, init_state, _ = ts.build_train_step(
            cfg, dataclasses.replace(run, remat=remat), mesh=None)
        st = jax.eval_shape(init_state, jax.random.key(0))
        ref[remat] = hlo_cost.analyze(step.lower(
            st, registry.input_specs(cfg, cell)).compile().as_text()).flops

    monkeypatch.setattr(pperf, "PERF_DIR", str(tmp_path))
    kw = dict(mesh_kind="one", device="cpu", reduced=True, batch=4, seq=128)
    block = pperf.run("qwen3-1.7b", "train_4k", {}, "block", **kw)
    none = pperf.run("qwen3-1.7b", "train_4k", {"remat": "none"}, "none",
                     attribute=True, **kw)
    assert block["overrides"] == {} and none["overrides"] == {"remat": "none"}
    ratio = block["roofline"]["flops"] / none["roofline"]["flops"]
    assert 1.2 <= ratio <= 1.4, ratio
    assert ratio == pytest.approx(ref["block"] / ref["none"], rel=0.01)
    assert (tmp_path / "qwen3-1.7b__train_4k__none.json").exists()
    assert (tmp_path / "qwen3-1.7b__train_4k__none.ops.zst").exists()
    rows = none["attribution"]
    assert rows and all(len(r) == 3 for r in rows)
    assert sum(r[1] for r in rows) <= none["roofline"]["flops"]


def test_set_overrides_are_typed_as_the_reference_types_them():
    from repro.configs.base import RunConfig as RefRun

    from repro_torch.configs.base import RunConfig

    sets = {"microbatch": "4", "remat": "none", "zero1": "false",
            "seq_shard_decode": "1", "q_chunk": "256"}
    got = pperf.typed_overrides(RunConfig(), sets)
    ref = {}
    for k, v in sets.items():     # repro/launch/perf.py:39-44
        cur = getattr(RefRun(), k)
        ref[k] = type(cur)(v) if cur is not None and not isinstance(cur, bool) \
            else (v in ("1", "true", "True") if isinstance(cur, bool) else v)
    assert got == ref == {"microbatch": 4, "remat": "none", "zero1": False,
                          "seq_shard_decode": True, "q_chunk": 256}


def _synthetic_results():
    """Result dicts that exercise every branch of the tables."""
    def ok(arch, cell, mesh, bottleneck, useful, coll, mfu=0.31):
        return {
            "arch": arch, "cell": cell, "mesh": mesh, "status": "ok",
            "compile_s": 12.6,
            "memory": {"argument_bytes": 3.2e9, "output_bytes": 4.5e6,
                       "temp_bytes": 7.1e4},
            "collectives": coll,
            "collective_ops": {k: 3 for k in coll},
            "roofline": {"compute_s": 1.7, "memory_s": 2.3e-3,
                         "memory_fused_s": 1.2e-3, "collective_s": 4.2e-7,
                         "bottleneck": bottleneck,
                         "model_flops_total": 3.6e15,
                         "useful_flops_ratio": useful, "mfu_bound": mfu}}

    res = {}
    for r in (
        ok("qwen3-1.7b", "train_4k", "single", "compute", 0.93,
           {"all-gather": 5e9, "reduce-scatter": 2e9}),
        ok("qwen3-1.7b", "train_4k", "multi", "collective", 0.8,
           {"all-reduce": 7e9, "all-gather": 1e9}),
        ok("qwen3-1.7b", "decode_32k", "single", "memory", 0.1, {}),
        ok("gemma2-2b", "prefill_32k", "single", "memory", 0.7,
           {"all-to-all": 1e6}),
        ok("whisper-base", "train_4k", "single", "collective", 120.0, {}),
        {"arch": "qwen3-1.7b", "cell": "long_500k", "mesh": "single",
         "status": "skipped", "reason": "x"},
        {"arch": "dbrx-132b", "cell": "train_4k", "mesh": "single",
         "status": "error", "error": "boom"},
        {"arch": "dbrx-132b", "cell": "train_4k", "mesh": "multi",
         "status": "error", "error": "boom"},
    ):
        res[(r["arch"], r["cell"], r["mesh"])] = r
    return res


def test_report_tables_equal_reference():
    from repro.launch import report as rreport

    res = _synthetic_results()
    assert preport.CELL_ORDER == rreport.CELL_ORDER
    assert preport.ARCH_ORDER == rreport.ARCH_ORDER
    assert preport.dryrun_table(res) == rreport.dryrun_table(res)
    for mesh in ("single", "multi"):
        assert preport.roofline_table(res, mesh) == \
            rreport.roofline_table(res, mesh)
    assert preport.summary(res) == rreport.summary(res)
    for r in res.values():
        if r["status"] == "ok":
            assert preport.suggest_move(r) == rreport.suggest_move(r)
    for b in (12, 4.5e4, 3.2e6, 7.7e9):
        assert preport.fmt_bytes(b) == rreport.fmt_bytes(b)
    for s in (3e-7, 2.5e-3, 1.25, 300.0):
        assert preport.fmt_s(s) == rreport.fmt_s(s)


def test_compare_and_report_clis_equal_reference(tmp_path, monkeypatch):
    """Both packages' compare over the same baseline and optimized
    directories print the same table; each report reads its own package's
    directory back."""
    from repro.launch import compare as rcompare

    res = _synthetic_results()
    opt = {k: dict(v, roofline=dict(v["roofline"], mfu_bound=0.47,
                                    bottleneck="compute"))
           if v["status"] == "ok" else v for k, v in res.items()}
    for d, rs in (("dryrun", res), ("dryrun_opt", opt),
                  ("dryrun_torch", res), ("dryrun_torch_opt", opt)):
        os.makedirs(tmp_path / "results" / d)
        for i, r in enumerate(rs.values()):
            with open(tmp_path / "results" / d / f"{i}.json", "w") as f:
                json.dump(r, f)
    monkeypatch.chdir(tmp_path)
    outs = []
    for fn in (rcompare.main, __import__(
            "repro_torch.launch.compare", fromlist=["main"]).main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "geometric-mean MFU-bound improvement over 4 cells" in outs[1]
    assert preport.load("results/dryrun_torch") == res
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        preport.main([])
    text = buf.getvalue()
    assert preport.dryrun_table(res) in text
    assert "256 H100s" in text and preport.roofline_table(res) in text


def test_reanalyze_gives_the_same_terms(tmp_path, monkeypatch):
    """The saved op record recounts to the first run's terms, through
    reanalyze() and the CLI's --reanalyze."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    res = dryrun.run_cell("granite-moe-1b-a400m", "prefill_32k", "one",
                          device="cpu", reduced=True, batch=2, seq=32,
                          save=True)
    with open(dryrun._result_path(res["arch"], res["cell"], "one"), "w") as f:
        json.dump(res, f)
    record = dryrun.load_record(res["arch"], res["cell"], "one")
    assert len(record) == res["ops"] > 0
    again = dryrun.reanalyze(res["arch"], res["cell"], "one")
    assert again["roofline"] == res["roofline"]
    assert again["collectives"] == res["collectives"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dryrun.main(["--reanalyze"]) == 0
    assert buf.getvalue().strip() == "reanalyzed 1 cells"


# the dot FLOPs a device times the ranks against the one-rank mesh's: every
# product runs on each rank's share (ROADMAP C.4; before, 1.20x on (2, 2)
# and 1.60x on (1, 4) for train)
MESH_DOT_RTOL = 0.02
FAMILY_DOT_RTOL = 0.005
# train_4k's families, and qwen3 with 6 query heads on 4 model ranks
SHARE_FAMILIES = ("gemma2-2b", "granite-moe-1b-a400m", "rwkv6-1.6b",
                  "recurrentgemma-9b", "whisper-base")
SHARE_HEADS = ("qwen3-1.7b", 6)


def test_every_product_runs_on_its_rank_share():
    """Reduced configs (batch 4, seq 32) on fake meshes (1, 1), (2, 2)
    and (1, 4) (``dryrun.rank_shares``), in five subprocesses: the dot
    FLOPs a device times the ranks within MESH_DOT_RTOL of the (1, 1)
    count for qwen3-1.7b train_4k and prefill_32k, within FAMILY_DOT_RTOL
    for train_4k of gemma2-2b, granite-moe (the router on each rank's
    tokens), rwkv6-1.6b (the decay LoRA on each rank's columns; 2 heads
    on 4 ranks: each one head's half of the value columns),
    recurrentgemma-9b and whisper-base (ROADMAP C.5).  Attention's
    ``bmm`` batch (batch rows times query heads) is over (1, 1)'s divided
    by the ranks, and with 6 query heads on 4 model ranks no rank runs
    more than ceil(6 / 4)."""
    code = textwrap.dedent("""
        import json, sys
        from repro_torch.launch import dryrun
        out = {}
        for job in sys.argv[1:]:
            arch, cell, heads = job.split(":")
            got = dryrun.rank_shares(arch, cell, heads=int(heads) or None)
            for mesh, r in got.items():
                out[f"{arch}:{heads} {cell} {mesh}"] = r
        print(json.dumps(out))
    """)
    # five processes, each its own fake group, a share of the cells each
    arch, heads = SHARE_HEADS
    gemma, granite, rwkv, rgemma, whisper = SHARE_FAMILIES
    groups = ([f"{arch}:train_4k:0", f"{arch}:prefill_32k:0"],
              [f"{arch}:train_4k:{heads}", f"{gemma}:train_4k:0"],
              [f"{granite}:train_4k:0", f"{whisper}:train_4k:0"],
              [f"{rwkv}:train_4k:0"], [f"{rgemma}:train_4k:0"])
    procs = [subprocess.Popen([sys.executable, "-c", code, *jobs], cwd=ROOT,
                              env=dict(os.environ,
                                       PYTHONPATH=str(ROOT / "src"),
                                       OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for jobs in groups]
    got = {}
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, out[-3000:] + err[-3000:]
        got.update(json.loads(out.strip().splitlines()[-1]))
    cases = [("qwen3-1.7b", c, MESH_DOT_RTOL)
             for c in ("train_4k", "prefill_32k")]
    cases += [(a, "train_4k", FAMILY_DOT_RTOL) for a in SHARE_FAMILIES]
    for a, cell, rtol in cases:
        one = got[f"{a}:0 {cell} 1x1"]
        assert one["dot"] > 0 and one["n_bmm"] > 0
        for shape, ranks in (("2x2", 4), ("1x4", 4)):
            r = got[f"{a}:0 {cell} {shape}"]
            assert r["dot"] * ranks == pytest.approx(one["dot"], rel=rtol), \
                (a, cell, shape, r["dot"] * ranks / one["dot"])
            assert r["n_bmm"] == one["n_bmm"], (a, cell, shape)
            if a != "rwkv6-1.6b":     # its loop's bmm: rows x heads
                assert r["bmm_batch"] * ranks <= one["bmm_batch"], \
                    (a, cell, shape)
    one = got[f"{arch}:{heads} train_4k 1x1"]
    rows = one["bmm_batch"] // heads            # batch rows a microbatch
    for shape, (data, model) in (("2x2", (2, 2)), ("1x4", (1, 4))):
        r = got[f"{arch}:{heads} train_4k {shape}"]
        assert r["n_bmm"] == one["n_bmm"]
        assert r["bmm_batch"] <= rows // data * -(-heads // model), \
            (shape, r["bmm_batch"])


# a head count that does not divide the model axis against its twin that
# does, at the same width (ROADMAP C.6): (arch, heads, twin's heads)
SHARE_TWINS = (("qwen3-1.7b", 6, 8), ("rwkv6-1.6b", 2, 4))


def _activation_reduces(ops, lead):
    """All-reduce counts by operand rank, of the operands whose leading
    dims are ``lead`` (activations ``[B, S, ...]``)."""
    out = {}
    for key, n in ops.items():
        kind, shape = key.split(" ", 1)
        shape = json.loads(shape)
        if kind == "all-reduce" and shape[:2] == lead:
            out[len(shape)] = out.get(len(shape), 0) + n
    return out


def test_heads_that_do_not_divide_the_axis_keep_their_shards():
    """``dryrun.rank_shares`` on (1, 4), two subprocesses: reduced qwen3
    train_4k with 6 query heads hands its collectives the bytes, and runs
    the collective ops, of its 8-head twin, to the byte (the projections
    split by whole heads: 2, 2, 2 and 0 a rank, no gather of q, the
    output row parallel into wo — 766,020 bytes and 111 ops before, the
    twin's 544,836 and 87), and its dot FLOPs are the twin's (GSPMD pads
    6 heads to 8).  Reduced rwkv6 with 2 heads (each rank one head's half
    of the value columns) against its 4-head twin (``heads_overrides``:
    twice as wide): its output leaves the loop as the flat dim's shard, so
    it all-reduces the twin's activations, by count and rank, and no
    zero-padded ``[B, S, H, dh]`` block; the gathers of r, k and the
    decay to whole heads, which the value-column split needs on each rank,
    remain (ROADMAP C.6)."""
    code = textwrap.dedent("""
        import json, sys
        from repro_torch.launch import dryrun
        arch, heads, twin = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
        print(json.dumps({h: dryrun.rank_shares(arch, "train_4k", heads=h)
                          for h in (heads, twin)}))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, arch, str(h),
                               str(t)], cwd=ROOT,
                              env=dict(os.environ,
                                       PYTHONPATH=str(ROOT / "src"),
                                       OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for arch, h, t in SHARE_TWINS]
    got = {}
    for (arch, h, t), proc in zip(SHARE_TWINS, procs):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, out[-3000:] + err[-3000:]
        got[arch] = json.loads(out.strip().splitlines()[-1])
    q6, q8 = (got["qwen3-1.7b"][h]["1x4"] for h in ("6", "8"))
    counts = {k: (q6[k], q8[k]) for k in ("coll", "n_coll", "dot")}
    assert q6["coll"] == q8["coll"] and q6["n_coll"] == q8["n_coll"], counts
    assert q6["coll_ops"] == q8["coll_ops"], counts
    assert q6["dot"] == q8["dot"], counts
    r2, r4 = (got["rwkv6-1.6b"][h]["1x4"] for h in ("2", "4"))
    lead = [2, 32]                     # a microbatch's rows, the sequence
    assert _activation_reduces(r2["coll_ops"], lead) == \
        _activation_reduces(r4["coll_ops"], lead), (r2["coll_ops"],
                                                    r4["coll_ops"])
    assert 4 not in _activation_reduces(r2["coll_ops"], lead)
