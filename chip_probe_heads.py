#!/usr/bin/env python3
"""Step time and host profile of heads that do not divide the model axis,
over NCCL on four H100s of one host, one rank a card.

    python3 chip_probe_heads.py [--src DIR] [--tag NAME] [--steps N]

Runs ``chip_probe_four.py`` (c)'s reduced qwen3-1.7b case with 6 query
heads on the (1, 4) ("data", "model") mesh and its twin with 8 (``HEADS``,
``HEADS_TWIN``; batch x seq ``CUT_BATCH``, FSDP rules, ZeRO-1, float32),
each in a process group of its own: ``init_state``, then ``--steps``
steps, each timed on the host clock between synchronisations, then one
more step under ``cProfile`` (host seconds in all, in
``torch.distributed.tensor`` — DTensor's dispatch, sharding propagation
and redistribution —, in the sharding propagator, the DTensor ops
dispatched and the propagator's cache misses) and one under
``torch.profiler`` (the card's busy milliseconds: its kernels' device
time, NCCL's apart, since an NCCL kernel's time counts its wait for the
other ranks).  ``--src`` names the ``src`` directory whose
``repro_torch`` the ranks import (default this checkout's): to compare
two trees, unpack the other under ``build/`` and run the script for each
in one call, in the order A, B, B, A.

Prints one line a head count and writes
``chiprun_out/chip_probe_heads_<tag>.json``.  Exits 1 on fewer than four
cards, or when a rank fails.  Imports no jax and nothing of the JAX
package.
"""
import argparse
import cProfile
import json
import os
import pstats
import statistics
import sys
import time
import traceback

import chip_probe_four as P

ROOT = P.ROOT
WORLD = 4
TIMEOUT_S = 600
TOP = 12


def _profile_sums(prof) -> dict:
    """Host seconds of one profiled step: in all, inside
    ``torch.distributed.tensor`` (its functions' own time), inside the
    sharding propagator (cumulative, outermost calls), the call counts of
    DTensor's op dispatch (where it is Python) and of the propagator's
    uncached path, and the ``TOP`` functions by their own time and
    DTensor's by their cumulative time ([name, seconds, calls])."""
    st = pstats.Stats(prof)
    total = dtensor = 0.0
    prop = dispatch = misses = 0
    prop_s = dispatch_s = 0.0
    for (path, _, name), (_, ncalls, tt, ct, _) in st.stats.items():
        total += tt
        path = path.replace(os.sep, "/")
        if "torch/distributed/tensor/" not in path:
            continue
        dtensor += tt
        if path.endswith("_sharding_prop.py") and name == "propagate":
            prop, prop_s = prop + ncalls, prop_s + ct
        if path.endswith("_dispatch.py") and name == "dispatch":
            dispatch, dispatch_s = dispatch + ncalls, dispatch_s + ct
        if name == "propagate_op_sharding_non_cached":
            misses += ncalls
    def top(rows):
        rows = sorted(rows, key=lambda r: -r[1])[:TOP]
        return [[f"{os.path.basename(f)}:{ln} {n}", round(t, 6), c]
                for (f, ln, n), t, c in rows]

    rows = st.stats.items()
    return dict(host_s=total, dtensor_s=dtensor, propagate_s=prop_s,
                propagate_calls=prop, dispatch_s=dispatch_s,
                dispatch_calls=dispatch, propagate_misses=misses,
                top_self=top([(k, v[2], v[1]) for k, v in rows]),
                top_dtensor_cum=top([
                    (k, v[3], v[1]) for k, v in rows
                    if "torch/distributed/tensor/" in k[0].replace(os.sep,
                                                                   "/")]))


def _device_ms(torch, step, state, b, cuda) -> tuple:
    """One step under torch.profiler: (state, the card's ms in its
    kernels but NCCL's, ms in NCCL's kernels, which count their wait for
    the other ranks too)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        state, _ = step(state, b)
        if cuda:
            torch.cuda.synchronize()
    busy = comm = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if "nccl" in e.key.lower():
                comm += t
            else:
                busy += t
    return state, busy / 1e3, comm / 1e3


def heads_rank(rank, port, job, results):
    """One rank: the job's head count through init and its steps."""
    sys.path.insert(0, job["src"])
    import torch
    import torch.distributed as dist

    try:
        import dataclasses

        from repro_torch.configs import registry
        from repro_torch.core.distributed import (init_process_group,
                                                  rank_device)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.train import train_step as ts
        from repro_torch.train.data import SyntheticLM

        from repro_torch.models.layers import exact_matmuls
        exact_matmuls()
        if job["device"] == "cpu":
            torch.set_num_threads(1)
        init_process_group(rank, job["world"], f"tcp://localhost:{port}",
                           device=job["device"])
        dev = rank_device(job["device"], rank)
        card = P.Card(torch, dev)
        arch, _, shape = P.HEADS
        cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                                  num_heads=job["heads"])
        batch, seq = job["batch"]
        mesh = make_mesh(shape, ("data", "model"), device=dev)
        step, init, _ = ts.build_train_step(cfg, P.lm_run(seq), P.lm_opt(),
                                            mesh=mesh, device=dev)
        t0 = time.perf_counter()
        state = init(0)
        card.sync()
        init_s = time.perf_counter() - t0
        src = SyntheticLM(cfg, batch, seq, seed=0)
        secs, losses = [], []
        for i in range(job["steps"]):
            card.sync()
            t0 = time.perf_counter()
            state, stats = step(state, src.batch_at(i))
            card.sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(stats["loss"]))
        prof = cProfile.Profile()
        b = src.batch_at(job["steps"])
        card.sync()
        prof.enable()
        state, _ = step(state, b)
        card.sync()
        prof.disable()
        state, busy, comm = _device_ms(torch, step, state,
                                       src.batch_at(job["steps"] + 1),
                                       card.cuda)
        results.put((rank, "ok", dict(
            repro_torch=os.path.dirname(sys.modules["repro_torch"].__file__),
            init_s=init_s, step_ms=[1e3 * t for t in secs], losses=losses,
            profile=_profile_sums(prof), device_busy_ms=busy,
            nccl_kernel_ms=comm)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def summary(heads, got) -> dict:
    """The ranks' numbers of one head count, as printed."""
    ranks = [got[r][1] for r in sorted(got)]
    later = [ms for r in ranks for ms in r["step_ms"][2:]]
    return dict(
        heads=heads, first_step_ms=[r["step_ms"][0] for r in ranks],
        later_step_ms_median=statistics.median(later),
        later_step_ms_range=[min(later), max(later)],
        profiled_host_s=[r["profile"]["host_s"] for r in ranks],
        dtensor_s=[r["profile"]["dtensor_s"] for r in ranks],
        propagate_s=[r["profile"]["propagate_s"] for r in ranks],
        dispatch_calls=[r["profile"]["dispatch_calls"] for r in ranks],
        propagate_misses=[r["profile"]["propagate_misses"] for r in ranks],
        device_busy_ms=[r["device_busy_ms"] for r in ranks],
        nccl_kernel_ms=[r["nccl_kernel_ms"] for r in ranks],
        losses=ranks[0]["losses"])


def card_info() -> str:
    """The cards' names and power limits, as nvidia-smi gives them."""
    import subprocess

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="run")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card a rank, NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < WORLD:
            print(f"needs {WORLD} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        print(card_info(), flush=True)
    out = dict(src=os.path.abspath(args.src), tag=args.tag, cases=[])
    ok = True
    for heads in (P.HEADS[1], P.HEADS_TWIN):
        job = dict(world=WORLD, device=args.device, heads=heads,
                   batch=P.CUT_BATCH, steps=args.steps,
                   src=os.path.abspath(args.src))
        t0 = time.perf_counter()
        for _ in range(2):              # once more where the port was taken
            got = P.run_ranks(job, TIMEOUT_S, target=heads_rank)
            bad = [r for r in range(WORLD)
                   if r not in got or got[r][0] != "ok"]
            if not any("EADDRINUSE" in str(got[r][1]) for r in bad
                       if r in got):
                break
        if bad:
            ok = False
            out["cases"].append(dict(heads=heads, failed=bad, ranks={
                r: got[r] for r in got}))
            continue
        line = dict(summary(heads, got), seconds=time.perf_counter() - t0)
        print(json.dumps(dict(tag=args.tag, **line)), flush=True)
        out["cases"].append(dict(line, ranks={r: got[r][1] for r in got}))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"chip_probe_heads_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
