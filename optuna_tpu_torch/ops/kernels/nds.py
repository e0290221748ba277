"""NSGA-II dominance matrix: the hand-written CUDA kernel and its plain
PyTorch version (port of ``optuna_tpu/ops/pallas/nds.py``).

:func:`dominance_matrix` computes what the reference's broadcast branch
computes: ``out[i, j] = 1.0`` iff row ``i`` dominates row ``j`` under
minimisation. For CUDA tensors it launches ``csrc/dominance.cu`` or raises;
for CPU tensors it runs :func:`dominance_matrix_plain`. Compares only, so
the two are bit-exact.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "dominance.cu"

#: Row multiple the ranking pads to (``ops/pareto.py``); the reference's tile.
TILE = 128

#: Kernel launches since the last reset; counts only real launches.
LAUNCHES = 0


def dominance_matrix_plain(values: torch.Tensor) -> torch.Tensor:
    """(N, N) float32 dominance matrix with broadcast ops."""
    leq = torch.all(values[:, None, :] <= values[None, :, :], dim=-1)
    lt = torch.any(values[:, None, :] < values[None, :, :], dim=-1)
    return (leq & lt).to(torch.float32)


@functools.cache
def _launcher():
    """The built kernel's C entry point, with its argument types declared."""
    from optuna_tpu_torch.ops.kernels import _nvcc

    fn = _nvcc.load(_SOURCE).dominance_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(values: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if values.dtype != torch.float32:
        raise TypeError(f"dominance_matrix: values must be float32, got {values.dtype}.")
    if values.dim() != 2:
        raise ValueError(f"dominance_matrix: values {tuple(values.shape)} must be (n, m).")
    n, m = values.shape
    v = values.contiguous()
    out = torch.empty((n, n), dtype=torch.float32, device=values.device)
    fn = _launcher()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(v.data_ptr(), out.data_ptr(), n, m, stream)
    if err != 0:
        raise RuntimeError(f"dominance_matrix kernel launch failed: CUDA error {err}.")
    LAUNCHES += 1
    return out


def dominance_matrix(values: torch.Tensor) -> torch.Tensor:
    """(N, N) float32 dominance matrix of (N, M) ``values``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if values.device.type == "cuda":
        return _launch(values)
    if values.device.type == "cpu":
        return dominance_matrix_plain(values)
    raise ValueError(f"dominance_matrix: unsupported device {values.device}.")
