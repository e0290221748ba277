"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

A wrapper runs the plain version only for tensors on the CPU (the tests);
for CUDA tensors it launches its kernel or raises. Kernels are built from
``csrc/`` with ``nvcc`` at first use (:mod:`._nvcc`).
"""
