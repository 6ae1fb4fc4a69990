"""Hand-written CUDA kernels for the GAB hot loop, with their plain PyTorch
versions (``ref``) and the device dispatch (``ops``).  Sources live in
``csrc/`` and are built with ``nvcc`` at first use (``_build``).
"""
