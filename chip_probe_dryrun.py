#!/usr/bin/env python3
"""The dry run's counter on this machine's torch, without jax.

    python3 chip_probe_dryrun.py

1. The DTensor counting trap: a [4096, 2048] @ [2048, 8192] matmul
   sharded (Shard(0), Replicate()) x (Replicate(), Shard(1)) on a
   (16, 16) mesh of a fake process group of 256 ranks, on fake tensors
   of the CPU's and (where there is a card) the card's device type, each
   in a fresh process: ``roofline/hlo_cost.py`` must count the local
   shard's product alone, 2 * 256 * 512 * 2048 FLOPs.
2. Reduced qwen3-1.7b train_4k, prefill_32k and decode_32k and
   granite-moe-1b-a400m train_4k on a (2, 2) fake mesh, batch 4 x 32
   (``launch/dryrun.py:run_cell``, as ``tests/test_torch_dryrun.py`` runs
   them): FLOPs, bytes, collective bytes, temporary bytes and ops a
   device, to hold against the same cells on another torch release.
3. Reduced qwen3-1.7b train_4k and prefill_32k on (1, 1), (2, 2) and
   (1, 4) fake meshes: the dot FLOPs a device times the ranks against
   (1, 1)'s and the largest attention ``bmm`` batch (ROADMAP C.4, as
   ``tests/test_torch_dryrun.py`` holds them).

Prints one JSON line and writes it to chiprun_out/chip_probe_dryrun.json;
exits non-zero when the trap counts anything but the local product or a
product in 3 runs on more than its rank's share.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

TRAP = r'''
import json, sys, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline import hlo_cost
dev = sys.argv[1]
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
try:
    mesh = init_device_mesh(dev, (16, 16), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(4096, 2048, device=dev), mesh,
                              [Shard(0), Replicate()])
        b = distribute_tensor(torch.empty(2048, 8192, device=dev), mesh,
                              [Replicate(), Shard(1)])
        r = hlo_cost.run(lambda x, y: x @ y, a, b)
finally:
    dist.destroy_process_group()
print(json.dumps(dict(flops=r.cost.flops, ops=[o.name for o in r.records])))
'''

CELLS = r'''
import json
from repro_torch.launch import dryrun
out = {}
for arch, cell in (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                   ("qwen3-1.7b", "decode_32k"),
                   ("granite-moe-1b-a400m", "train_4k")):
    r = dryrun.run_cell(arch, cell, "single", device="cpu", reduced=True,
                        mesh_shape=(2, 2), batch=4, seq=32)
    rf = r["roofline"]
    out[f"{arch} {cell}"] = dict(flops=rf["flops"], bytes=rf["hbm_bytes"],
                                 coll_bytes=rf["coll_bytes"],
                                 temp_bytes=r["memory"]["temp_bytes"],
                                 ops=r["ops"])
print(json.dumps(out))
'''

SHARES = r'''
import json
from repro_torch.launch import dryrun
from repro_torch.roofline import hlo_cost
import tempfile
dryrun.RESULTS_DIR = tempfile.mkdtemp()
out = {}
for cell in ("train_4k", "prefill_32k"):
    for shape in ((1, 1), (2, 2), (1, 4)):
        dryrun.run_cell("qwen3-1.7b", cell, "single", device="cpu",
                        reduced=True, mesh_shape=shape, batch=4, seq=32,
                        save=True)
        rec = dryrun.load_record("qwen3-1.7b", cell, "single")
        out[f"{cell} {shape[0]}x{shape[1]}"] = dict(
            dot=hlo_cost.dot_flops(rec),
            bmm_batch=max(r[1][0][1][0] for r in rec
                          if r[0].startswith("aten.bmm.")))
print(json.dumps(out))
'''
SHARE_RTOL = 0.02      # tests/test_torch_dryrun.py's MESH_DOT_RTOL


def shares_ok(shares):
    """Every product on its rank's share: the dot FLOPs a device times the
    ranks within SHARE_RTOL of (1, 1)'s, the attention bmm's batch (rows
    times query heads) at most (1, 1)'s over the ranks."""
    ok = True
    for cell in ("train_4k", "prefill_32k"):
        one = shares[f"{cell} 1x1"]
        for shape in ("2x2", "1x4"):
            r = shares[f"{cell} {shape}"]
            r["dot_x_ranks_vs_1x1"] = 4 * r["dot"] / one["dot"]
            ok &= abs(r["dot_x_ranks_vs_1x1"] - 1) <= SHARE_RTOL
            ok &= 4 * r["bmm_batch"] <= one["bmm_batch"]
    return ok


def run(code, *args):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"chip_probe_dryrun: {args}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    import torch

    want = 2.0 * 256 * 512 * 2048
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    out = dict(torch=torch.__version__,
               card=torch.cuda.get_device_name(0) if len(devices) > 1
               else None,
               trap={d: run(TRAP, d) for d in devices}, cells=run(CELLS),
               shares=run(SHARES))
    shares = shares_ok(out["shares"])
    line = json.dumps(out)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_probe_dryrun.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    bad = [d for d, t in out["trap"].items() if t["flops"] != want]
    return 1 if bad or not shares else 0


if __name__ == "__main__":
    sys.exit(main())
