"""GraphH on PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``src/repro/`` module for module.  The port imports
``torch`` and ``numpy`` only, never ``jax`` and never ``repro``; host-side
code (SPE, the tile store, the edge cache, broadcast measurement) stays
numpy, and tensors begin at the device boundary.  Every entry point takes
an explicit device whose default is ``"cuda"``.
"""
