"""Serving driver: batched requests through the continuous-batching engine
— counterpart of ``repro/launch/serve.py``, with ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --requests 16 --slots 4 --max-new 16 [--ckpt-dir DIR] \
        [--device cpu]

Parameters are random from ``--seed`` (``LM.init``), or ``state["params"]``
of a checkpoint that either package's ``CheckpointManager`` wrote
(``--ckpt-dir``).  Computes in float32 (TF32 off), on the card unless
``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig
from repro_torch.models.model_zoo import build_model, load_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.graph_service import bind_device
from repro_torch.train.checkpoint import CheckpointManager


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="load trained params from a checkpoint")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = bind_device(args.device)
    # float32 means float32: no TF32 in the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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
    run = RunConfig(remat="none", q_chunk=64, kv_chunk=64,
                    compute_dtype="float32")
    model = build_model(cfg, run, device)
    if args.ckpt_dir:
        _, state = CheckpointManager(args.ckpt_dir).restore()
        load_params(model, state["params"])
        print("loaded params from", args.ckpt_dir)
    else:
        model.init(args.seed)

    eng = ServeEngine(cfg, run, model, slots=args.slots,
                      max_len=args.max_len, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for i in range(args.requests)]
    t0 = time.time()
    outs = eng.run_requests(reqs)
    dt = time.time() - t0
    tok = sum(len(o.tokens) for o in outs)
    print(f"{len(outs)} completions, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s, {eng.stats['decode_steps']} decode steps, "
          f"slots={args.slots})")
    for o in sorted(outs, key=lambda x: x.rid)[:4]:
        print(f"  req {o.rid}: {o.tokens[:12]}{'...' if len(o.tokens)>12 else ''}")
    return outs


if __name__ == "__main__":
    main()
