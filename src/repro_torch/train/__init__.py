"""Training substrate of the port: so far the checkpoint manager that the
graph engine's superstep checkpoints build on (``train/checkpoint.py``)
and the LM serve CLI restores parameters through; the rest of the
reference's ``train`` package is ROADMAP.md A.13.2."""
