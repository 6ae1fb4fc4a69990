"""Baseline vs optimized sweep comparison — counterpart of
``repro/launch/compare.py``, over ``results/dryrun_torch`` and
``results/dryrun_torch_opt``.

    PYTHONPATH=src python -m repro_torch.launch.compare
"""
from repro_torch.launch.report import ARCH_ORDER, CELL_ORDER, load


def main(base_dir="results/dryrun_torch", opt_dir="results/dryrun_torch_opt"):
    base = load(base_dir)
    opt = load(opt_dir)
    print("| arch | cell | MFU-bound base -> opt | x | bottleneck base -> opt | useful base -> opt |")
    print("|---|---|---|---|---|---|")
    gains = []
    for arch in ARCH_ORDER:
        for cell in CELL_ORDER:
            b = base.get((arch, cell, "single"))
            o = opt.get((arch, cell, "single"))
            if not b or not o or b["status"] != "ok" or o["status"] != "ok":
                continue
            rb, ro = b["roofline"], o["roofline"]
            x = ro["mfu_bound"] / max(rb["mfu_bound"], 1e-9)
            gains.append(x)
            print(f"| {arch} | {cell} | {rb['mfu_bound']:.4f} -> {ro['mfu_bound']:.4f} "
                  f"| {x:.1f}x | {rb['bottleneck'][:4]} -> {ro['bottleneck'][:4]} "
                  f"| {rb['useful_flops_ratio']:.2f} -> {min(ro['useful_flops_ratio'],99):.2f} |")
    if gains:
        import statistics
        print(f"\ngeometric-mean MFU-bound improvement over "
              f"{len(gains)} cells: "
              f"{statistics.geometric_mean(gains):.2f}x")


if __name__ == "__main__":
    main()
