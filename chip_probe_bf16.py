#!/usr/bin/env python3
"""chip_smoke.py's language models in bfloat16 (phase 24) on one card,
without the graph phases.

    python3 chip_probe_bf16.py

Runs phase 19 (the dense decoders served in float32, whose figures
phase 24 logs beside its own) and then phase 24, with phase 24's counts
on fake tensors in DryRuns' side process started at the beginning (the
rank-shares process beside it is stopped): the phase waits for them,
~290 s of one core on the H100 machine's host, where the smoke starts
them after phase 7.  Its checks are the smoke's; its details go to
chiprun_out/chip_probe_bf16.json.  About 8 minutes in all.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("chip_probe_bf16: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = smoke.card_info(torch)
    smoke.exact_matmuls()
    dry = smoke.DryRuns((), os.path.join(ROOT, "build", "chip_smoke_dryrun"))
    for key, proc, _ in dry.procs:
        if key[0] == "rank_shares":
            proc.kill()
    try:
        lm_serve = smoke.lm_serve_phase(torch)
        smoke.log(f"[phase 19: {time.perf_counter() - t0:.1f} s]")
        t1 = time.perf_counter()
        out = smoke.lm_bf16_phase(torch, dry, lm_serve, smi)
        smoke.log(f"[phase 24: {time.perf_counter() - t1:.1f} s; "
                  f"{time.perf_counter() - t0:.1f} s in all]")
    finally:
        dry.kill()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_probe_bf16.json"),
              "w") as f:
        json.dump(dict(card=smi, lm_serve=lm_serve, lm_bf16=out), f,
                  indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
