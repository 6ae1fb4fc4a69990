"""Multi-pod dry run: count every (arch x shape x mesh) cell without
allocating it — counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 256 or 512 placeholder
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=512``) and
reads XLA's memory analysis and the optimized HLO.  The port runs its own
train, prefill or decode function once:

  * on fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``):
    shapes, dtypes and devices, no storage;
  * over the production mesh (``launch/mesh.py``) built on a fake process
    group of world size 256 or 512, as rank 0 — the counterpart of the
    reference's ``XLA_FLAGS`` lines.  Only :func:`run_cell` joins it, and
    leaves it before it returns: the fake group must never share a
    process with a real one, so the CLI and ``--all`` run each cell in its
    own process;
  * inside ``roofline/hlo_cost.py``, which counts the local ops each
    device dispatches (FLOPs, bytes, collective bytes) and the live bytes.

Per cell this produces:
  * memory: argument, output and temporary bytes a device (proves it fits)
  * per-device FLOPs / bytes / collective bytes for the roofline
  * the three roofline terms + bottleneck + MFU bound, on the H100's
    figures (``roofline/hw.py``: datasheet numbers, not measurements)
  * the op record (each op, its local shapes and dtypes, its module path),
    saved compressed beside the result; ``--reanalyze`` recounts from it.

``device`` is the card (``"cuda"``) unless the caller asks for ``"cpu"``:
fake tensors of that device type, and a mesh of that type.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --cell train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # one subprocess a cell
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.roofline import analysis as ra

RESULTS_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "results", "dryrun_torch"))

MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


@contextlib.contextmanager
def emulated_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks:
    collectives return at once with outputs of the right shape.  Left on
    exit.  Refuses to run beside an initialised group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry run's fake group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(spec, device):
    import torch

    return torch.zeros(spec.shape, dtype=getattr(torch, spec.dtype),
                       device=device)


def _fake_inputs(specs: dict, device) -> dict:
    return {k: _fake(v, device) for k, v in specs.items()}


@dataclasses.dataclass
class CellCount:
    """One cell counted: the hlo_cost result and what the roofline needs."""

    counted: object               # hlo_cost.Counted
    layers: int
    n_params: int
    n_active: int
    model_flops: float
    build_s: float
    count_s: float


def param_counts(cfg, run) -> tuple[int, int]:
    """(parameters, active parameters) from a model on the meta device."""
    from repro_torch.models import model_zoo

    meta = model_zoo.build_model(cfg, run, "meta")
    return (model_zoo.param_count(meta),
            model_zoo.active_param_count(cfg, meta))


def cell_model_flops(cfg, cell, n_active: int) -> float:
    """The cell's model FLOPs (``analysis.model_flops``, the embedding
    table left out): 6ND for train, 2ND for prefill, 2N a sequence for
    decode."""
    embed_p = cfg.vocab_size * cfg.d_model
    tokens = (cell.global_batch if cell.kind == "decode"
              else cell.global_batch * cell.seq_len)
    return ra.model_flops(cell.kind, n_active, tokens, embed_p)


def cell_summary(arch: str, cell_name: str, reduced: bool = False) -> dict:
    """``params``, ``active_params`` and ``model_flops_total`` of a cell at
    the production mesh's run config, with nothing run."""
    cell = SHAPE_CELLS[cell_name]
    cfg = registry.get_config(arch, reduced=reduced)
    run = registry.default_run_config(arch, cell, _world("single"))
    n_params, n_active = param_counts(cfg, run)
    return {"params": n_params, "active_params": n_active,
            "model_flops_total": cell_model_flops(cfg, cell, n_active)}


def count_cell(cfg, run, cell, mesh, device) -> CellCount:
    """Build ``cell``'s function for ``cfg`` and ``run`` on ``mesh`` (None:
    one device) and count one call of it, all on fake tensors.  The caller
    has joined the process group the mesh needs."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import sharding as shd
    from repro_torch.roofline import hlo_cost
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts

    t0 = time.time()
    n_params, n_active = param_counts(cfg, run)
    mflops = cell_model_flops(cfg, cell, n_active)
    with FakeTensorMode():
        if cell.kind == "train":
            step, init_state, _ = ts.build_train_step(cfg, run, mesh=mesh,
                                                      device=device)
            fn, args = step, (init_state(0), _fake_inputs(
                registry.input_specs(cfg, cell), device))
        else:
            fns = serve_step.build_serve_fns(
                cfg, run, mesh=mesh, max_len=cell.seq_len,
                batch=cell.global_batch, device=device)
            model = fns["model"]
            if mesh is not None:        # placed before the counted call,
                with torch.inference_mode():    # as the call would place it
                    shd.distribute_model_(model, mesh, fns["rules"])
            cache = fns["init_cache"]()
            if cell.kind == "prefill":
                fn, args = fns["prefill"], (model, cache, _fake_inputs(
                    registry.input_specs(cfg, cell), device))
            else:   # decode: one new token against a seq_len cache
                B, S = cell.global_batch, cell.seq_len
                if cfg.encoder_layers > 0:    # prefilled first
                    cache, _ = fns["prefill"](model, cache, _fake_inputs({
                        "tokens": registry.InputSpec((B, S - 1), "int32"),
                        "enc_frames": registry.InputSpec(
                            (B, S // 2, cfg.d_model), "bfloat16")}, device))
                tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
                fn, args = fns["decode"], (model, cache, tok, S - 1)
        build_s = time.time() - t0
        t0 = time.time()
        counted = hlo_cost.run(fn, *args)
        count_s = time.time() - t0
    return CellCount(counted, cfg.num_layers, n_params, n_active, mflops,
                     build_s, count_s)


def _make_mesh(mesh_kind: str, device: str, shape=None):
    from repro_torch.launch import mesh as meshlib

    if shape is not None:
        axes = ("data", "model")[-len(shape):] if len(shape) <= 2 else \
            ("pod", "data", "model")
        return meshlib.make_mesh(tuple(shape), axes, device=device)
    return meshlib.make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                        device=device)


def _world(mesh_kind: str, shape=None) -> int:
    shape = shape if shape is not None else MESH_SHAPES[mesh_kind]
    n = 1
    for s in shape:
        n *= s
    return n


def _terms(cost, n_chips, mflops):
    return ra.roofline(cost.flops, cost.bytes, cost.coll_bytes, n_chips,
                       mflops, hbm_bytes_fused=cost.bytes_fused)


def count(arch: str, cell_name: str, mesh_kind: str, device: str, *,
          reduced: bool = False, mesh_shape=None, batch=None, seq=None,
          layers=None, overrides=None, model_overrides=None):
    """``(CellCount, n_chips, RunConfig)`` of one cell (:func:`run_cell`'s
    arguments; ``overrides`` replace fields of the cell's RunConfig,
    ``model_overrides`` those of its ModelConfig), inside the emulated
    world its mesh needs."""
    cell = SHAPE_CELLS[cell_name]
    if batch is not None or seq is not None:
        cell = dataclasses.replace(
            cell, global_batch=batch or cell.global_batch,
            seq_len=seq or cell.seq_len)
    cfg = registry.get_config(arch, reduced=reduced)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    n_chips = 1 if mesh_kind == "one" else _world(mesh_kind, mesh_shape)
    run = registry.default_run_config(arch, cell, n_chips)
    if overrides:
        run = dataclasses.replace(run, **overrides)
    with contextlib.ExitStack() as stack:
        mesh = None
        if mesh_kind != "one":
            stack.enter_context(emulated_world(n_chips))
            mesh = _make_mesh(mesh_kind, device, mesh_shape)
        cc = count_cell(cfg, run, cell, mesh, device)
    return cc, n_chips, run


SHARE_MESHES = ((1, 1), (2, 2), (1, 4))


def heads_overrides(cfg, heads: int) -> dict:
    """The config fields that give ``cfg`` ``heads`` query heads:
    ``num_heads``; for RWKV, whose heads are the 64-wide slices of its
    width, also ``num_kv_heads`` and the width ``d_model = heads · 64``
    that holds them."""
    if "K" in cfg.layer_pattern:
        from repro_torch.models.rwkv6 import rwkv_head_dim

        return {"num_heads": heads, "num_kv_heads": heads,
                "d_model": heads * rwkv_head_dim(cfg)}
    return {"num_heads": heads}


def rank_shares(arch: str, cell_name: str, *, heads=None) -> dict:
    """What one rank computes of the reduced ``arch``'s cell at batch 4 x
    seq 32 (its query heads ``heads`` when given: :func:`heads_overrides`)
    on each fake ("data", "model") mesh of ``SHARE_MESHES``, on the CPU:
    ``{"DxM": {"dot": its dot FLOPs (hlo_cost.dot_flops), "bmm_batch":
    the largest bmm's batch, "n_bmm": its bmm count, "coll": the operand
    bytes it hands to collectives, "n_coll": its collective ops,
    "coll_ops": {"<kind> <operand shape>": count}}}``.  A
    mesh's dot FLOPs times its ranks against (1, 1)'s say whether some
    product runs whole on every rank of an axis (ROADMAP C.4, C.5); the
    bmm batch is attention's batch rows times query heads; a head count
    that does not divide the model axis against one that does, at the
    same width, says whether its tensors keep their shards (C.6)."""
    from repro_torch.roofline import analysis, hlo_cost

    over = None
    if heads is not None:
        over = heads_overrides(registry.get_config(arch, reduced=True),
                               heads)
    out = {}
    for shape in SHARE_MESHES:
        cc, _, _ = count(arch, cell_name, "single", "cpu", reduced=True,
                         mesh_shape=shape, batch=4, seq=32,
                         model_overrides=over)
        rec = [r.as_list() for r in cc.counted.records]
        bmm = [r[1][0][1][0] for r in rec if r[0].startswith("aten.bmm.")]
        coll = analysis.collective_bytes(rec)
        ops: dict = {}
        for r in rec:
            kind = hlo_cost.op_kind(r[0])
            if kind.startswith("coll:"):
                key = f"{kind[5:]} {list(r[1][0][1]) if r[1] else []}"
                ops[key] = ops.get(key, 0) + 1
        out[f"{shape[0]}x{shape[1]}"] = dict(
            dot=hlo_cost.dot_flops(rec), bmm_batch=max(bmm, default=0),
            n_bmm=len(bmm), coll=coll["total"],
            n_coll=sum(coll["op_counts"].values()), coll_ops=ops)
    return out


def run_cell(arch: str, cell_name: str, mesh_kind: str,
             device: str = "cuda", *, reduced: bool = False,
             mesh_shape=None, batch=None, seq=None, layers=None,
             save: bool = False) -> dict:
    """One cell's result dict: the reference's keys, and ``layers`` (the
    depth that ran), ``ops`` (the record's op count), ``dot_flops`` (its
    products' FLOPs a device, ``hlo_cost.dot_flops``), ``collective_bytes``
    and ``collective_op_total`` (the operand bytes a device hands to
    collectives and their op count).  ``mesh_kind`` is ``single`` (16 x 16), ``multi`` (2 x
    16 x 16) or ``one`` (no mesh, one device); ``mesh_shape`` replaces the
    production shape; ``reduced``, ``batch`` and ``seq`` cut the cell to
    a test's size, ``layers`` its depth (the CLI's ``--layers``: every
    position and width as at full depth).  With ``save`` the op record
    goes beside the results."""
    from repro_torch.roofline import hlo_cost

    ok, reason = registry.cell_runnable(arch, cell_name)
    if not ok:
        return {"arch": arch, "cell": cell_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    cc, n_chips, run = count(arch, cell_name, mesh_kind, device,
                             reduced=reduced, mesh_shape=mesh_shape,
                             batch=batch, seq=seq, layers=layers)
    records = cc.counted.records
    cost = cc.counted.cost
    if save:
        save_record(_record_path(arch, cell_name, mesh_kind), records)
    terms = _terms(cost, n_chips, cc.model_flops)
    coll = ra.collective_bytes(records)
    return {
        "arch": arch, "cell": cell_name, "mesh": mesh_kind,
        "status": "ok",
        "n_chips": n_chips,
        "params": cc.n_params, "active_params": cc.n_active,
        "lower_s": round(cc.build_s, 2), "compile_s": round(cc.count_s, 2),
        "memory": cc.counted.memory.as_dict(),
        "collectives": {k: int(v) for k, v in cost.coll_by_kind.items()},
        "collective_ops": coll.get("op_counts", {}),
        "unknown_trip_loops": cost.unknown_trip_loops,
        "xla_cost": {"flops_per_dev_loopbody_once": None,
                     "bytes_per_dev_loopbody_once": None},
        "roofline": terms.as_dict(),
        "run_config": {"sharding_mode": run.sharding_mode,
                       "microbatch": run.microbatch, "remat": run.remat},
        "device": device, "layers": cc.layers, "ops": len(records),
        "dot_flops": hlo_cost.dot_flops(records),
        "collective_bytes": int(coll["total"]),
        "collective_op_total": int(sum(coll.get("op_counts", {}).values())),
    }


def _result_path(arch, cell, mesh_kind):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{cell}__{mesh_kind}.json")


def _record_path(arch, cell, mesh_kind):
    d = os.path.join(RESULTS_DIR, "ops")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{cell}__{mesh_kind}.ops.zst")


def save_record(path, records) -> None:
    """An op record as compressed JSON (``compat.zstd_compress``: zlib
    where zstandard is missing)."""
    from repro_torch.compat import zstd_compress

    text = json.dumps([r.as_list() for r in records], separators=(",", ":"))
    with open(path, "wb") as f:
        f.write(zstd_compress(text.encode(), level=3))


def load_record(arch, cell, mesh_kind) -> list:
    """The saved op record of a cell (``hlo_cost.OpRecord`` lists)."""
    from repro_torch.compat import zstd_decompress

    with open(_record_path(arch, cell, mesh_kind), "rb") as f:
        return json.loads(zstd_decompress(f.read()).decode())


def reanalyze(arch, cell, mesh_kind) -> dict:
    """Recompute the roofline terms from the saved op record (no rerun) —
    used when the cost model improves."""
    from repro_torch.roofline import hlo_cost

    path = _result_path(arch, cell, mesh_kind)
    with open(path) as f:
        res = json.load(f)
    if res.get("status") != "ok":
        return res
    records = load_record(arch, cell, mesh_kind)
    cost = hlo_cost.count(records)
    terms = _terms(cost, res["n_chips"], res["roofline"]["model_flops_total"])
    res["roofline"] = terms.as_dict()
    res["collectives"] = {k: int(v) for k, v in cost.coll_by_kind.items()}
    res["unknown_trip_loops"] = cost.unknown_trip_loops
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None,
                    help="one shape cell (default: every cell of --arch)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute rooflines from saved op records, no runs")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh "
                         "(default cuda)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth: a count takes host time in "
                         "proportion to the ops it dispatches")
    args = ap.parse_args(argv)

    if args.reanalyze:
        import glob as _glob
        n = 0
        for p in sorted(_glob.glob(os.path.join(RESULTS_DIR, "*.json"))):
            base = os.path.basename(p)[:-5]
            arch, cell, mk = base.split("__")
            if os.path.exists(_record_path(arch, cell, mk)):
                reanalyze(arch, cell, mk)
                n += 1
        print(f"reanalyzed {n} cells")
        return 0

    if args.all or args.cell is None:
        archs = registry.ARCH_IDS if args.all else [args.arch]
        meshes = args.meshes.split(",") if args.all else [args.mesh]
        jobs = [(arch, cell, mk) for arch in archs for cell in SHAPE_CELLS
                for mk in meshes]
        done = ok = failed = 0
        for arch, cell, mk in jobs:
            path = _result_path(arch, cell, mk)
            if os.path.exists(path) and not args.force:
                done += 1
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--cell", cell, "--mesh", mk,
                   "--device", args.device]
            if args.layers is not None:
                cmd += ["--layers", str(args.layers)]
            src = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                               "..", ".."))
            r = subprocess.run(cmd, capture_output=True, text=True,
                               env={**os.environ, "PYTHONPATH": src,
                                    "REPRO_TORCH_DRYRUN_DIR": RESULTS_DIR})
            if r.returncode == 0:
                ok += 1
            else:
                failed += 1
                with open(path, "w") as f:
                    json.dump({"arch": arch, "cell": cell, "mesh": mk,
                               "status": "error",
                               "error": r.stderr[-4000:]}, f, indent=1)
                print(f"FAIL {arch} {cell} {mk}", flush=True)
        print(f"all done: {ok} ran, {done} cached, {failed} failed")
        return 1 if failed else 0

    res = None
    try:
        res = run_cell(args.arch, args.cell, args.mesh, device=args.device,
                       layers=args.layers, save=True)
    except Exception:
        res = {"arch": args.arch, "cell": args.cell, "mesh": args.mesh,
               "status": "error", "error": traceback.format_exc()[-4000:]}
    with open(_result_path(args.arch, args.cell, args.mesh), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k in ("arch", "cell", "mesh", "status", "compile_s",
                               "layers", "collective_bytes",
                               "collective_op_total", "dot_flops")}))
    if res["status"] == "error":
        print(res["error"][-2000:], file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
