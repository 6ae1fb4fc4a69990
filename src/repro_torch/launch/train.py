"""End-to-end training CLI — counterpart of ``repro/launch/train.py``,
with ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir DIR \
        [--device cpu]

Every arch of the registry trains through the same flags: the dense,
RG-LRU, RWKV6 and mixture-of-experts decoders, the vision frontend (its
batches carry ``patch_embeds``) and the encoder-decoder (``enc_frames``).
Features exercised: registry configs, synthetic deterministic data
pipeline with prefetch, AdamW + schedule, microbatching, checkpointing
every N steps in the reference's tree (``model_zoo.export_state``: either
package's CLI resumes the other's checkpoints), preemption-safe resume
(rerun the same command after an interruption and it continues),
optional gradient compression.  Computes in float32 (TF32 off), on the
card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig
from repro_torch.models import layers
from repro_torch.models.model_zoo import export_state, param_count
from repro_torch.runtime.ft import FaultTolerantLoop
from repro_torch.serve.graph_service import bind_device
from repro_torch.train import data as datalib
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "topk"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = bind_device(args.device)
    # float32 means float32 and bfloat16 sums in float32 (no TF32, no
    # reduced-precision reduction): the reference's dots
    layers.exact_matmuls()

    cfg = registry.get_config(args.arch, reduced=args.reduced)
    overrides = {}
    if args.d_model:
        overrides.update(d_model=args.d_model,
                         d_ff=int(args.d_model * 8 / 3 / 128) * 128 or 128,
                         head_dim=64,
                         num_heads=max(args.d_model // 64, 1),
                         num_kv_heads=max(args.d_model // 128, 1))
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    run = RunConfig(remat="block", microbatch=args.microbatch,
                    q_chunk=min(512, args.seq), kv_chunk=min(512, args.seq),
                    loss_chunk=min(512, args.seq),
                    grad_compression=args.grad_compression,
                    compute_dtype="float32")
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 10),
                        decay_steps=args.steps)

    step_fn, init_state, _ = ts.build_train_step(cfg, run, opt_cfg, mesh=None,
                                                 device=device)
    source = datalib.SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    ft = (FaultTolerantLoop(ckpt, save_every=args.ckpt_every,
                            export=export_state) if ckpt else None)

    t0 = time.time()
    if ft is not None:
        start, state = ft.resume_or_init(lambda: init_state(args.seed))
        if start:
            print(f"resumed from checkpoint at step {start}")
    else:
        start, state = 0, init_state(args.seed)
    print(f"init in {time.time()-t0:.1f}s; params = "
          f"{param_count(state['params']):,}")

    prefetch = datalib.Prefetcher(source, start_step=start)
    losses = []
    t_loop = time.time()
    tokens_per_step = args.batch * args.seq
    stopped = False
    try:
        for step in range(start, args.steps):
            _, batch = prefetch.next()
            state, stats = step_fn(state, batch)
            losses.append(float(stats["loss"]))
            if ft is not None and ft.maybe_save(step + 1, state):
                print(f"[ckpt] step {step+1}")
            if (step + 1) % args.log_every == 0:
                dt = time.time() - t_loop
                done = step + 1 - start
                print(f"step {step+1:5d} loss {np.mean(losses[-args.log_every:]):.4f} "
                      f"lr {float(stats['lr']):.2e} gnorm {float(stats['grad_norm']):.2f} "
                      f"| {done*tokens_per_step/dt:,.0f} tok/s")
            if ft is not None and ft.should_stop():
                print("preempted: checkpointed and exiting")
                ft.maybe_save(step + 1, state, force=True)
                stopped = True
                break
    finally:
        prefetch.close()
        if ft is not None:
            ft.restore_handlers()
    # the reference also saves here after a preemption, labelling the
    # preempted state as step --steps (ROADMAP.md C); the port does not
    if ft is not None and not stopped and losses:
        ft.maybe_save(args.steps, state, force=True)
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
