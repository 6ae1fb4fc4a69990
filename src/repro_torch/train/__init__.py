"""Training substrate of the port: so far the checkpoint manager that the
graph engine's superstep checkpoints build on (``train/checkpoint.py``);
the rest of the reference's ``train`` package is ROADMAP.md queue A.13."""
