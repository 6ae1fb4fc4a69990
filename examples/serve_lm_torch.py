"""Batched serving on the PyTorch port: continuous batching over 24
requests with 4 cache slots, loading weights from
``examples/train_lm_torch.py`` when present, on an H100 (or the CPU).

    PYTHONPATH=src python examples/serve_lm_torch.py [--ckpt-dir DIR] [--device cpu]

The same example as ``examples/serve_lm.py``, through
``repro_torch.launch.serve``.  ``--d-model``, ``--layers``, ``--vocab``
and ``--requests`` must match the checkpoint's model when one is served
(the defaults are the reference's, and ``train_lm_torch.py``'s).
"""
import argparse
import os
import tempfile

import torch

from repro_torch.launch import serve

CKPT_DIR = os.path.join(tempfile.gettempdir(), "train_lm_100m_torch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--requests", type=int, default=24)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    argv = [
        "--arch", "qwen3-1.7b", "--reduced",
        # same shape overrides as examples/train_lm_torch.py (the ~100M
        # model)
        "--d-model", str(args.d_model), "--layers", str(args.layers),
        "--vocab", str(args.vocab),
        "--requests", str(args.requests), "--slots", "4",
        "--max-new", "24", "--max-len", "256", "--prompt-len", "16",
        "--temperature", "0.8", "--device", args.device,
    ]
    if os.path.isdir(args.ckpt_dir) and os.listdir(args.ckpt_dir):
        argv += ["--ckpt-dir", args.ckpt_dir]
    else:
        print("(no checkpoint found — serving randomly initialized weights; "
              "run examples/train_lm_torch.py first)")
    serve.main(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
