"""Render results/dryrun_torch/*.json into the §Dry-run and §Roofline
tables — counterpart of ``repro/launch/report.py``.  The roofline terms
are modelled for 256 (or 512) H100s from datasheet figures
(``roofline/hw.py``), not measured.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

CELL_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = ["whisper-base", "qwen3-14b", "qwen3-1.7b", "gemma2-2b",
              "deepseek-7b", "internvl2-76b", "recurrentgemma-9b",
              "dbrx-132b", "granite-moe-1b-a400m", "rwkv6-1.6b"]


def load(dirname):
    out = {}
    for p in glob.glob(os.path.join(dirname, "*.json")):
        with open(p) as f:
            r = json.load(f)
        out[(r["arch"], r["cell"], r["mesh"])] = r
    return out


def fmt_bytes(b):
    if b >= 1e9:
        return f"{b/1e9:.2f}G"
    if b >= 1e6:
        return f"{b/1e6:.1f}M"
    return f"{b/1e3:.0f}K"


def fmt_s(s):
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.1f}us"


def dryrun_table(res):
    lines = [
        "| arch | cell | mesh | status | compile | bytes/dev (args+out+temp) | collectives (ops) |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for cell in CELL_ORDER:
            for mesh in ("single", "multi"):
                r = res.get((arch, cell, mesh))
                if r is None:
                    continue
                if r["status"] == "skipped":
                    lines.append(f"| {arch} | {cell} | {mesh} | SKIP (assignment) | | | |")
                    continue
                if r["status"] != "ok":
                    lines.append(f"| {arch} | {cell} | {mesh} | **ERROR** | | | |")
                    continue
                m = r["memory"]
                mem = (f"{fmt_bytes(m.get('argument_bytes',0))}+"
                       f"{fmt_bytes(m.get('output_bytes',0))}+"
                       f"{fmt_bytes(m.get('temp_bytes',0))}")
                ops = ", ".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in
                                sorted(r.get("collective_ops", {}).items()))
                lines.append(
                    f"| {arch} | {cell} | {mesh} | ok | {r['compile_s']:.0f}s "
                    f"| {mem} | {ops} |")
    return "\n".join(lines)


def roofline_table(res, mesh="single"):
    lines = [
        "| arch | cell | compute | mem (fused/cons) | collective | bound | model TFLOP | useful | MFU-bound | next move |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for cell in CELL_ORDER:
            r = res.get((arch, cell, mesh))
            if r is None or r["status"] == "skipped":
                if r is not None:
                    lines.append(f"| {arch} | {cell} | — | — | — | skip | | | | |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {cell} | ERROR | | | | | | | |")
                continue
            rf = r["roofline"]
            move = suggest_move(r)
            fused = rf.get("memory_fused_s", rf["memory_s"])
            lines.append(
                f"| {arch} | {cell} | {fmt_s(rf['compute_s'])} "
                f"| {fmt_s(fused)} / {fmt_s(rf['memory_s'])} "
                f"| {fmt_s(rf['collective_s'])} "
                f"| **{rf['bottleneck'][:4]}** "
                f"| {rf['model_flops_total']/1e12:.1f} "
                f"| {min(rf['useful_flops_ratio'],99):.2f} "
                f"| {rf['mfu_bound']:.3f} | {move} |")
    return "\n".join(lines)


def suggest_move(r) -> str:
    rf = r["roofline"]
    b = rf["bottleneck"]
    if b == "collective":
        top = max(r["collectives"], key=r["collectives"].get) if r["collectives"] else "?"
        return f"cut {top} traffic (sharding/overlap)"
    if b == "memory":
        if rf["useful_flops_ratio"] < 0.3:
            return "reduce replicated compute (shard heads/seq)"
        return "fuse/remat tuning; bigger per-step compute"
    return "increase arithmetic intensity or accept (compute-bound)"


def summary(res):
    ok = sum(1 for r in res.values() if r["status"] == "ok")
    skip = sum(1 for r in res.values() if r["status"] == "skipped")
    err = sum(1 for r in res.values() if r["status"] not in ("ok", "skipped"))
    return f"{ok} compiled ok, {skip} skipped (assignment rules), {err} errors"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline"])
    args = ap.parse_args(argv)
    res = load(args.dir)
    print(f"<!-- {summary(res)} -->\n")
    if args.section in ("all", "dryrun"):
        print("## Dry-run (both meshes)\n")
        print(dryrun_table(res))
        print()
    if args.section in ("all", "roofline"):
        print("## Roofline (256 H100s as a 16x16 mesh, per-device terms, "
              "modelled)\n")
        print(roofline_table(res))


if __name__ == "__main__":
    main()
