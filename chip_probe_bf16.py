#!/usr/bin/env python3
"""chip_smoke.py's language models in bfloat16 (phases 24 and 25) on one
card, without the graph phases.

    python3 chip_probe_bf16.py

Runs phase 19 (the dense decoders served in float32, whose figures
phases 24 and 25 log beside their own) and phase 21 (the families in
float32, beside phase 25's), then phases 24 and 25, with their counts on
fake tensors in DryRuns' side process and phase 25's CPU half in a
Side process, all started at the beginning (the rank-shares process
beside them is stopped): the phases wait for them, ~290 s of one core on
the H100 machine's host, where the smoke starts them after phase 7.
Its checks are the smoke's; its details go to
chiprun_out/chip_probe_bf16.json.  About 10 minutes in all.

    python3 chip_probe_bf16.py --alone

Runs phase 25 (b)'s rwkv6-1.6b part alone (lm_bf16_alone), every one of
the serve CLI's requests alone in a 1-slot and a 4-slot engine against
its batched slot, with no bound on the 1-slot distance: the readings
LM_BF16_ALONE_ULPS is set from (each step's distance in ulps of its
row's largest |logit|, and the largest over sqrt(step)), to
chiprun_out/chip_probe_bf16_alone.json.  About 2 minutes.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def alone(torch, smoke, smi, t0):
    """--alone (module docstring)."""
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.parse_args(["--arch", smoke.LM_BF16_ALONE_ARCH])
    smoke.LM_SINGLE_RIDS = tuple(range(args.requests))
    smoke.LM_BF16_ALONE_ULPS = float("inf")
    f32 = dict(prefill_ms=0.0, decode_step_ms=0.0, tokens_per_s=0.0,
               torch_peak_bytes=0)           # no float32 run beside it
    out = smoke.lm_bf16_alone(torch, dict(serve_cli=f32))
    rows = {rid: dict(same_slots_equal=a["same_slots_equal"],
                      steps_compared=a["steps_compared"],
                      ulps_by_step=a["ulps_by_step"],
                      err_by_step=a["err_by_step"])
            for rid, a in out["alone"].items()}
    walk = max(u / i ** 0.5 for r in rows.values()
               for i, u in enumerate(r["ulps_by_step"]) if i)
    res = dict(card=smi, rows=rows, max_ulps_over_sqrt_step=walk,
               decode_step_ms=out["decode_step_ms"],
               seconds=time.perf_counter() - t0)
    smoke.log(f"every request alone in {out['slots']} slots equal to its "
              f"batched slot: "
              f"{all(r['same_slots_equal'] for r in rows.values())}; "
              f"1 slot, prefill ulps "
              f"{sorted({r['ulps_by_step'][0] for r in rows.values()})}, "
              f"largest ulps / sqrt(step) {walk:.3f}")
    return res


def main():
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("chip_probe_bf16: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = smoke.card_info(torch)
    if sys.argv[1:] == ["--alone"]:
        smoke.exact_matmuls()
        res = alone(torch, smoke, smi, t0)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_probe_bf16_alone.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    smoke.exact_matmuls()
    dry = smoke.DryRuns((), os.path.join(ROOT, "build", "chip_smoke_dryrun"))
    for key, proc, _ in dry.procs:
        if key[0] == "rank_shares":
            proc.kill()
    cpu_side = smoke.Side("lm_bf16_family_cpu")
    out = {}
    try:
        for name, run in (
                ("19", lambda: smoke.lm_serve_phase(torch)),
                ("21", lambda: smoke.lm_families_phase(torch)),
                ("24", lambda: smoke.lm_bf16_phase(torch, dry, out["19"],
                                                   smi)),
                ("25", lambda: smoke.lm_bf16_family_phase(
                    torch, dry, cpu_side, out["19"], out["21"], out["24"],
                    smi))):
            t1 = time.perf_counter()
            smoke.reset_launches()
            out[name] = run()
            smoke.log(f"[phase {name}: {time.perf_counter() - t1:.1f} s, "
                      f"{time.perf_counter() - t0:.1f} s in all; launches "
                      f"{smoke.read_launches()}]")
    finally:
        dry.kill()
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_probe_bf16.json"),
                  "w") as f:
            json.dump(dict(card=smi, phases=out), f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
