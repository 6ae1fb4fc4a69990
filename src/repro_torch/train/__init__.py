"""Training substrate of the port: the checkpoint manager
(``train/checkpoint.py``) that the graph engine's superstep checkpoints
build on and both LM CLIs restore through, the synthetic and binary-corpus
data with prefetch (``train/data.py``), AdamW with its schedule, clipping
and gradient compression (``train/optimizer.py``), and the train step on
one device or over a device mesh (``train/train_step.py``)."""
