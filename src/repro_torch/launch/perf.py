"""Perf hill-climbing runner: recount a single (arch, cell) with RunConfig
overrides — counterpart of ``repro/launch/perf.py``.  Results land in
``results/perf_torch/<arch>__<cell>__<label>.json`` with the op record
beside them.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-14b \\
      --cell train_4k --label it1_flat --set attn_shard=flat [--device cpu]

Each cell runs on fake tensors over the production mesh's fake process
group, as ``launch/dryrun.py`` runs it (one process per run).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis as ra, hlo_cost

PERF_DIR = os.environ.get(
    "REPRO_TORCH_PERF_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "results", "perf_torch"))


def typed_overrides(run_cfg, overrides: dict) -> dict:
    """``--set key=value`` strings typed as the RunConfig field they
    replace (the reference's rule: a bool from 1/true/True)."""
    typed = {}
    for k, v in overrides.items():
        cur = getattr(run_cfg, k)
        typed[k] = type(cur)(v) if cur is not None and not isinstance(cur, bool) \
            else (v in ("1", "true", "True") if isinstance(cur, bool) else v)
    return typed


def run(arch: str, cell_name: str, overrides: dict, label: str,
        mesh_kind: str = "single", attribute: bool = False,
        device: str = "cuda", *, reduced: bool = False, mesh_shape=None,
        batch=None, seq=None) -> dict:
    """Counts the cell with ``overrides`` and writes the result (module
    docstring); ``mesh_kind`` ``one`` runs without a mesh, and
    ``reduced``/``mesh_shape``/``batch``/``seq`` cut the cell as
    ``dryrun.run_cell`` does."""
    typed = typed_overrides(
        registry.default_run_config(arch, SHAPE_CELLS[cell_name]), overrides)
    t0 = time.time()
    cc, n_chips, _ = dryrun.count(arch, cell_name, mesh_kind, device,
                                  reduced=reduced, mesh_shape=mesh_shape,
                                  batch=batch, seq=seq, overrides=typed)
    records = cc.counted.records
    os.makedirs(PERF_DIR, exist_ok=True)
    dryrun.save_record(os.path.join(
        PERF_DIR, f"{arch}__{cell_name}__{label}.ops.zst"), records)
    cost = cc.counted.cost
    terms = ra.roofline(cost.flops, cost.bytes, cost.coll_bytes, n_chips,
                        cc.model_flops, hbm_bytes_fused=cost.bytes_fused)
    out = {
        "arch": arch, "cell": cell_name, "label": label,
        "overrides": typed, "compile_s": round(time.time() - t0, 1),
        "roofline": terms.as_dict(),
        "collectives": {k: int(v) for k, v in cost.coll_by_kind.items()},
    }
    if attribute:
        out["attribution"] = [
            (t, round(f, 0), round(b, 0))
            for t, f, b in hlo_cost.attribute(records, depth=6, top_k=12)]
    with open(os.path.join(PERF_DIR, f"{arch}__{cell_name}__{label}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig override key=value")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--attribute", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh "
                         "(default cuda)")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    out = run(args.arch, args.cell, overrides, args.label, args.mesh,
              args.attribute, args.device)
    rf = out["roofline"]
    print(json.dumps({
        "label": args.label,
        "compute_s": round(rf["compute_s"], 4),
        "memory_s": round(rf["memory_s"], 4),
        "collective_s": round(rf["collective_s"], 4),
        "bottleneck": rf["bottleneck"],
        "useful": round(rf["useful_flops_ratio"], 3),
        "mfu_bound": round(rf["mfu_bound"], 4),
    }))


if __name__ == "__main__":
    main()
