"""The dry run's counts that chip_smoke.py's phase 24 holds the card to:
qwen3-1.7b's ``train_4k`` at batch 2 and ``decode_32k`` at batch 4 on one
device (``launch/dryrun.py``, mesh kind "one"), at full width and depth on
fake tensors, in bfloat16 (the cells' RunConfig); and, at the reduced
configs, a bfloat16 train step counted on real CPU tensors equal to the
same step counted on fake tensors (ops, FLOPs, bytes), the premise phase
24 checks on the card.  The full-width train count takes ~3 minutes of
one core."""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.launch import dryrun
from repro_torch.roofline import hlo_cost, hw
from repro_torch.train import train_step as ts
from repro_torch.train.data import SyntheticLM


@pytest.mark.parametrize("cell,batch", [("train_4k", 2), ("decode_32k", 4)])
def test_one_device_cells_count(cell, batch):
    """status ok on fake tensors, the compute and both memory terms above
    0 (one device: no collective, its term 0), the peak a device below
    the card's HBM, bfloat16 at the cell's own RunConfig."""
    r = dryrun.run_cell("qwen3-1.7b", cell, "one", device="cpu",
                        batch=batch)
    assert r["status"] == "ok" and r["n_chips"] == 1
    assert r["layers"] == registry.get_config("qwen3-1.7b").num_layers
    rf = r["roofline"]
    assert all(rf[k] > 0 for k in ("compute_s", "memory_s",
                                   "memory_fused_s", "step_s_bound"))
    assert rf["collective_s"] == 0 and r["collective_bytes"] == 0
    assert 0 < r["memory"]["peak_bytes_estimate"] < hw.HBM_BYTES
    run = registry.default_run_config("qwen3-1.7b", SHAPE_CELLS[cell], 1)
    assert run.compute_dtype == "bfloat16"
    assert r["run_config"] == {"sharding_mode": run.sharding_mode,
                               "microbatch": run.microbatch,
                               "remat": run.remat}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_real_and_fake_counts_agree(arch):
    """A reduced bfloat16 train step at the train_4k RunConfig (seq 64):
    counted on CPU tensors and on fake tensors of the same shapes, the
    same ops, FLOPs, bytes and fused bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = registry.get_config(arch, reduced=True)
    run = registry.default_run_config(
        arch, dataclasses.replace(SHAPE_CELLS["train_4k"], seq_len=64), 1)
    data = SyntheticLM(cfg, 2, 64, seed=0).batch_at(0)

    def count(batch):
        step, init, _ = ts.build_train_step(cfg, run, device="cpu")
        return hlo_cost.run(step, init(0), batch)

    real = count({k: torch.from_numpy(v) for k, v in data.items()})
    with FakeTensorMode():
        fake = count({k: torch.empty(v.shape, dtype=torch.int32)
                      for k, v in data.items()})
    assert len(real.records) == len(fake.records)
    assert (real.cost.flops, real.cost.bytes, real.cost.bytes_fused) == \
        (fake.cost.flops, fake.cost.bytes, fake.cost.bytes_fused)
