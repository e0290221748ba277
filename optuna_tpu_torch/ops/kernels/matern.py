"""Matérn-5/2 cross-covariance: the hand-written CUDA kernel and its plain
PyTorch version (port of ``optuna_tpu/ops/pallas/matern.py``).

:func:`matern52_gram` computes what the reference's XLA twin
``_matern52_xla`` computes, categorical (Hamming) dims included. For CUDA
tensors it launches ``csrc/matern52_gram.cu`` or raises; for CPU tensors it
runs :func:`matern52_gram_plain`. No gradient: the sparse engine calls it
only for the cross-covariance ``C = K(Z, X)``, outside any fit.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

_SOURCE = "matern52_gram.cu"
_SQRT5 = math.sqrt(5.0)

#: Kernel launches since the last reset; counts only real launches. Worker
#: threads of ``optimize(n_jobs=...)`` launch together, so the count is
#: raised under :data:`_COUNT_LOCK`.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def matern52_gram_plain(
    x1: torch.Tensor,
    x2: torch.Tensor,
    inv_sq_lengthscales: torch.Tensor,
    scale: torch.Tensor,
    cat_mask: torch.Tensor,
) -> torch.Tensor:
    """(n1, n2) Matérn-5/2 Gram, plain PyTorch: the kernel's arithmetic
    (direct differences, Hamming on categorical dims) with broadcast ops."""
    diff = x1[:, None, :] - x2[None, :, :]
    sq = torch.where(cat_mask, (diff != 0.0).to(x1.dtype), diff * diff)
    d2 = torch.sum(sq * inv_sq_lengthscales, dim=-1)
    pos = d2 > 0
    d = torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))), 0.0)
    sqrt5d = _SQRT5 * d
    return scale * (1.0 + sqrt5d + (5.0 / 3.0) * d2) * torch.exp(-sqrt5d)


def cat_bytes(cat_mask: torch.Tensor) -> torch.Tensor:
    """The bool ``cat_mask`` as the kernel reads it, one byte 0 or 1 a dim:
    a view of the same memory, so no cast kernel runs."""
    if cat_mask.dtype != torch.bool:
        raise TypeError(f"matern52_gram: cat_mask must be bool, got {cat_mask.dtype}.")
    return cat_mask.contiguous().view(torch.uint8)


@functools.cache
def _lib():
    """The built library of ``csrc/matern52_gram.cu``, bound."""
    from optuna_tpu_torch.ops.kernels import _nvcc

    return _nvcc.load(_SOURCE, bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the entry point of a library built from
    ``csrc/matern52_gram.cu`` (or a revision of it); returns ``lib``."""
    fn = lib.matern52_gram_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(x1, x2, w, scale, cat_mask, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The kernel of ``lib`` (default: the tree's, counted in :data:`LAUNCHES`)."""
    global LAUNCHES
    dev = x1.device
    for name, t in (("x2", x2), ("inv_sq_lengthscales", w), ("scale", scale), ("cat_mask", cat_mask)):
        if t.device != dev:
            raise ValueError(f"matern52_gram: {name} is on {t.device}, x1 on {dev}.")
    for name, t in (("x1", x1), ("x2", x2), ("inv_sq_lengthscales", w), ("scale", scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"matern52_gram: {name} must be float32, got {t.dtype}.")
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"matern52_gram: x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} must be (n, d).")
    d = x1.shape[1]
    if w.shape != (d,) or cat_mask.shape != (d,) or scale.numel() != 1:
        raise ValueError("matern52_gram: inv_sq_lengthscales and cat_mask must be (d,), scale one value.")
    x1c, x2c, wc = x1.contiguous(), x2.contiguous(), w.contiguous()
    sc = scale.reshape(1).contiguous()
    cat = cat_bytes(cat_mask)
    out = torch.empty((x1.shape[0], x2.shape[0]), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = (lib or _lib()).matern52_gram_launch(
        x1c.data_ptr(), x2c.data_ptr(), wc.data_ptr(), sc.data_ptr(), cat.data_ptr(),
        out.data_ptr(), x1.shape[0], x2.shape[0], d, dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"matern52_gram kernel launch failed: CUDA error {err}.")
    if lib is None:
        with _COUNT_LOCK:
            LAUNCHES += 1
    return out


def matern52_gram(
    x1: torch.Tensor,
    x2: torch.Tensor,
    inv_sq_lengthscales: torch.Tensor,
    scale: torch.Tensor,
    cat_mask: torch.Tensor,
) -> torch.Tensor:
    """(n1, n2) Matérn-5/2 cross-covariance: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x1.device.type == "cuda":
        return _launch(x1, x2, inv_sq_lengthscales, scale, cat_mask)
    if x1.device.type == "cpu":
        return matern52_gram_plain(x1, x2, inv_sq_lengthscales, scale, cat_mask)
    raise ValueError(f"matern52_gram: unsupported device {x1.device}.")
