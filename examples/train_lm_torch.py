"""End-to-end LM training on the PyTorch port: a ~100M-param qwen3-family
model for a few hundred steps on the synthetic pipeline, with
checkpointing and preemption-safe resume, on an H100 (or the CPU).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]

The same training run as ``examples/train_lm.py``, through
``repro_torch.launch.train`` (rerunning resumes from the checkpoint;
``examples/serve_lm_torch.py`` serves it).  ``--d-model``, ``--layers``,
``--vocab``, ``--batch`` and ``--seq`` shrink the model and the batch
(the defaults are the reference's).
"""
import argparse
import os
import tempfile

import torch

from repro_torch.launch import train

CKPT_DIR = os.path.join(tempfile.gettempdir(), "train_lm_100m_torch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    # ~100M params: 12 layers x d_model 512 + 32k vocab (tied embeddings)
    train.main([
        "--arch", "qwen3-1.7b", "--reduced",
        "--d-model", str(args.d_model), "--layers", str(args.layers),
        "--vocab", str(args.vocab),
        "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--microbatch", "2",
        "--lr", "6e-4",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "20", "--device", args.device,
    ])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
