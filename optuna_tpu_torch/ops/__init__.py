"""Numerical building blocks of the port (PyTorch ops; ``kernels/`` holds
the hand-written CUDA kernels)."""
