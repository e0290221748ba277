"""NSGA-II dominance and non-domination ranking: the hand-written CUDA
kernels and their plain PyTorch versions (port of
``optuna_tpu/ops/pallas/nds.py`` and the peeling loop of
``optuna_tpu/ops/pareto.py::non_domination_rank``).

:func:`rank_fronts` ranks (N, M) rows in two launches of
``csrc/dominance.cu`` whatever the number of fronts: a bit-packed
"dominated-by" matrix over the grid, then the whole front-peeling loop in
one block. :func:`dominance_matrix` computes what the reference's broadcast
branch computes, ``out[i, j] = 1.0`` iff row ``i`` dominates row ``j`` under
minimisation; no path calls it, it checks the compare that both kernels
share. For CUDA tensors each launches its kernel or raises; for CPU tensors
each runs its plain version. Compares only, so kernel and plain version are
bit-exact.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

_SOURCE = "dominance.cu"

#: Row multiple the ranking pads to (``ops/pareto.py``); the reference's tile.
TILE = 128

#: Launches of the dominance-matrix kernel since the last reset.
LAUNCHES = 0
#: Rankings launched by :func:`rank_fronts` since the last reset; each is
#: two kernel launches (the packed matrix, then the peel).
RANK_LAUNCHES = 0
#: Both counts are raised under this lock: worker threads of
#: ``optimize(n_jobs=...)`` launch together.
_COUNT_LOCK = threading.Lock()


def dominance_matrix_plain(values: torch.Tensor) -> torch.Tensor:
    """(N, N) float32 dominance matrix with broadcast ops."""
    leq = torch.all(values[:, None, :] <= values[None, :, :], dim=-1)
    lt = torch.any(values[:, None, :] < values[None, :, :], dim=-1)
    return (leq & lt).to(torch.float32)


#: Front steps between two host checks of the plain peeling loop.
FRONTS_PER_SYNC = 8


def rank_fronts_plain(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`rank_fronts` with torch ops: the reference's peeling loop over
    the broadcast dominance matrix. The host reads whether any row remains
    once every :data:`FRONTS_PER_SYNC` fronts; a step with no row left
    changes nothing."""
    n = values.shape[0]
    mask = mask.to(torch.float32)
    dom = dominance_matrix_plain(values) * mask[:, None] * mask[None, :]
    ranks = torch.full((n,), n + 1, dtype=torch.int32, device=values.device)
    remaining = mask.clone()
    r = 0
    while bool(torch.any(remaining > 0)):
        for _ in range(FRONTS_PER_SYNC):
            dominated = torch.any((dom * remaining[:, None]) > 0, dim=0)
            front = (remaining > 0) & ~dominated
            ranks = torch.where(front, r, ranks)
            remaining = torch.where(front, 0.0, remaining)
            r += 1
    fronts = torch.where(ranks <= n, ranks + 1, 0).amax().reshape(1) if n else ranks.new_zeros(1)
    return torch.cat([ranks, fronts])


@functools.cache
def _lib():
    """The built library of ``csrc/dominance.cu``, bound."""
    from optuna_tpu_torch.ops.kernels import _nvcc

    return _nvcc.load(_SOURCE, bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the entry points of a library built
    from ``csrc/dominance.cu`` (or a revision of it); returns ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, argtypes, restype in (
        ("dominance_launch", [ptr, ptr, i32, i32, i32, ptr], i32),
        ("nds_rank_scratch_words", [i32], ctypes.c_longlong),
        ("nds_rank_in_shared", [i32, i32], i32),
        ("nds_rank_launch", [ptr, ptr, ptr, ptr, i32, i32, i32, ptr], i32),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _check_values(name: str, values: torch.Tensor) -> None:
    if values.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32, got {values.dtype}.")
    if values.dim() != 2:
        raise ValueError(f"{name}: values {tuple(values.shape)} must be (n, m).")


def _launch(values: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    _check_values("dominance_matrix", values)
    n, m = values.shape
    v = values.contiguous()
    out = torch.empty((n, n), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _lib().dominance_launch(v.data_ptr(), out.data_ptr(), n, m, values.device.index, stream)
    if err != 0:
        raise RuntimeError(f"dominance_matrix kernel launch failed: CUDA error {err}.")
    with _COUNT_LOCK:
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


def ranks_in_shared(n: int, device: torch.device) -> bool:
    """Whether the peel of ``n`` rows on CUDA ``device`` stages the packed
    matrix in shared memory (else it reads it from global memory)."""
    return bool(_lib().nds_rank_in_shared(n, device.index))


def _rank_launch(values: torch.Tensor, mask: torch.Tensor, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The ranking kernels of ``lib`` (default: the tree's, counted in
    :data:`RANK_LAUNCHES`)."""
    global RANK_LAUNCHES
    _check_values("rank_fronts", values)
    n, m = values.shape
    if mask.shape != (n,) or mask.dtype != torch.float32:
        raise ValueError(f"rank_fronts: mask must be float32 ({n},), got {mask.dtype} {tuple(mask.shape)}.")
    dev = values.device
    if mask.device != dev:
        raise ValueError(f"rank_fronts: mask is on {mask.device}, values on {dev}.")
    out = torch.empty(n + 1, dtype=torch.int32, device=dev)
    if n == 0:
        return out.zero_()
    counted = lib is None
    lib = lib or _lib()
    v, mk = values.contiguous(), mask.contiguous()
    domby = torch.empty(lib.nds_rank_scratch_words(n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nds_rank_launch(v.data_ptr(), mk.data_ptr(), domby.data_ptr(), out.data_ptr(), n, m, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"rank_fronts kernel launch failed: CUDA error {err}.")
    if counted:
        with _COUNT_LOCK:
            RANK_LAUNCHES += 1
    return out


def rank_fronts(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Non-domination ranks of (N, M) float32 ``values`` (minimisation) under
    the (N,) float32 ``mask`` (rows with ``mask > 0`` are real).

    Returns (N + 1,) int32: ``[:N]`` the ranks, 0 for the Pareto front and
    ``N + 1`` for masked rows, and ``[N]`` the number of fronts, so one copy
    brings both to the host. The CUDA kernels for CUDA tensors, the plain
    version for CPU tensors.
    """
    if values.device.type == "cuda":
        return _rank_launch(values, mask)
    if values.device.type == "cpu":
        return rank_fronts_plain(values, mask)
    raise ValueError(f"rank_fronts: unsupported device {values.device}.")
