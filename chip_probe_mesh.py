#!/usr/bin/env python3
"""The mesh tests' gloo ranks on this machine's torch, without jax.

    python3 chip_probe_mesh.py

Runs the spawned CPU ranks of ``tests/test_torch_mesh.py`` (gloo, world
sizes 2 and 4, one torch thread a rank: three train steps of reduced
qwen3-1.7b under fsdp and tp and of granite-moe on every mesh of the
world size, and on (1, 4) of rwkv6 and of qwen3 with 6 query heads,
serving five families on (2, 2), flash-decoding, the elastic rescale,
``sharding.linear`` and ``sharding.logsumexp`` on shards, a remat
backward on a thread without the mesh context, per-shard init against
the whole init's shards) and
holds each against the port's mesh-free functions: the largest
difference of the losses and of the train state's leaves, of the served
logits, of the sharded products and log-sum-exps and their gradients,
and the placements that differ from the specs.  The test
file also holds them against the JAX package, which a machine without
jax cannot; this probe tries another torch release's DTensor (the chip
machine's) on the same cases.  Writes ``chiprun_out/chip_probe_mesh.json``;
exits 1 when a launch fails or a difference passes the tests' tolerance.
"""
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_mesh as T  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.train import optimizer, train_step  # noqa: E402


def free_train(name):
    """The mesh-free port's three steps of a train case."""
    cfg, mode = T._train_config(name)
    step, init, _ = train_step.build_train_step(
        cfg, T._train_run(mode), optimizer.OptConfig(**T.OPT_KW),
        device="cpu")
    state, losses = init(T.SEED), []
    for b in T._batches(cfg):
        state, stats = step(state, b)
        losses.append(float(stats["loss"]))
    return losses, model_zoo.export_state(state)


def leaf_diff(got, want):
    return max(float(np.max(np.abs(np.asarray(a, np.float64) - b)))
               for (_, a), (_, b) in zip(T._leaves(got), T._leaves(want)))


def check(world):
    t0 = time.perf_counter()
    got, _ = T._collect(world, *T._start(world))
    out = {"seconds": time.perf_counter() - t0, "train": {}, "serve": {}}
    ok = True
    for (mesh, name), r in got[0]["train"].items():
        losses, state = free_train(name)
        row = dict(loss=float(np.max(np.abs(np.subtract(r["losses"],
                                                        losses)))),
                   state=leaf_diff(r["state"], state),
                   misplaced=sum(len(g["train"][(mesh, name)]["misplaced"])
                                 for g in got.values()))
        ok &= (row["misplaced"] == 0 and bool(np.allclose(
            r["losses"], losses, **T.TOL)))
        out["train"][f"{mesh} {name}"] = row
    for (arch, seq), r in got[0].get("serve", {}).items():
        want = T._free_serve(arch, seq)
        err = max(float(np.max(np.abs(g - w)))
                  for g, w in zip(r["logits"], want))
        ok &= err <= T.SERVE_ATOL and not r["misplaced"]
        out["serve"][arch + (" seq" if seq else "")] = err
    out["flash"] = {str(n): max(v.values())
                    for n, v in got[0]["flash"].items()}
    ok &= max(out["flash"].values()) <= T.FLASH_ATOL
    out["linear"] = max(max(e) for r in got.values()
                        for e in r["linear"].values())
    out["logsumexp"] = max(max(e[:2]) for r in got.values()
                           for e in r["lse"].values())
    ok &= out["linear"] <= T.LINEAR_ATOL and out["logsumexp"] <= T.LSE_ATOL
    ok &= all(e[2] for r in got.values() for e in r["lse"].values())
    out["init_unequal_leaves"] = sum(len(c["unequal"]) for r in got.values()
                                     for c in r["init"].values())
    out["init_largest_over_leaf"] = max(
        c["largest_made"] / c["largest_leaf"] for r in got.values()
        for c in r["init"].values())
    ok &= (out["init_unequal_leaves"] == 0
           and out["init_largest_over_leaf"] <= 1.0)
    if "remat_thread" in got[0]:
        out["remat_thread"] = got[0]["remat_thread"]
        ok &= all(r["remat_thread"] == 0.0 for r in got.values())
    if "elastic" in got[0]:
        e = got[0]["elastic"]
        out["elastic"] = dict(checkpoint=e["loss_c"] - e["loss_a"],
                              reshard=e["loss_r"] - e["loss_a"])
        ok &= max(map(abs, out["elastic"].values())) <= T.ELASTIC_ATOL
    out["ok"] = bool(ok)
    return out


def main():
    print(f"torch {torch.__version__}", flush=True)
    out, ok = {}, True
    for world in (2, 4):
        try:
            out[world] = check(world)
        except Exception:
            out[world] = {"ok": False, "error": traceback.format_exc()}
        ok &= out[world]["ok"]
        print(f"world {world}: {json.dumps(out[world])}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_probe_mesh.json"),
              "w") as f:
        json.dump(dict(torch=torch.__version__, worlds=out), f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
