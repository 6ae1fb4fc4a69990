"""GraphH core on PyTorch: partitioning, GAB model, caches, comm, engine.

Submodules are imported explicitly by users (no eager imports here).
"""
