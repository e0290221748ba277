"""Config #5's head over a batch of MLPs in the wide layout: the hand-written
CUDA kernel and its plain PyTorch version.

No TPU kernel is replaced: the reference's trainer is plain ``jnp``. The
port's wide layout (``models/mlp.py::train_scaled_batch``) holds every
trial's first layer as one column block of ``W1`` (``(in, B*H)``), so the
first layer of all trials is one product ``Z = X @ W1`` of shape
``(N, B*H)``. The head is what lies between that product and the weight
gradient's ``X^T @ dH``: per example row and trial, the bias and ReLU, the
``H -> O`` layer, the softmax cross-entropy and its gradient back to the
hidden layer. :func:`head_step` writes ``lr * dH`` over ``Z`` in place and
returns the per-trial losses and the small gradients; :func:`head_loss` is
the loss alone. Its bound is bytes: reading ``Z`` and writing ``dH``.

Both versions sum over the same chunks of :data:`CHUNK_ROWS` rows, one
partials row per (chunk, trial), and :func:`_finish` adds the chunks in
order. No float atomics: a rerun gives the same bits. For CUDA tensors the
wrapper launches ``csrc/mlp_head.cu`` or raises; for CPU tensors it runs
:func:`head_partials_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

_SOURCE = "mlp_head.cu"
#: Rows one block of the kernel sums into one partials row (``kChunk``).
CHUNK_ROWS = 1024

#: Kernel launches since the last reset; counts only real launches.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


class HeadGrads(NamedTuple):
    loss: torch.Tensor  # (B,) mean cross-entropy before the step
    w2: torch.Tensor  # (B, H, O)
    b2: torch.Tensor  # (B, O)
    b1: torch.Tensor  # (B, H)


def head_partials_plain(
    z: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    labels: torch.Tensor,
    lr: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """The kernel's partials in plain PyTorch: ``(chunks, B, H*O + O + H + 1)``
    (``dW2``, ``db2``, ``db1``, the loss sum) with ``lr`` given, after which
    ``z`` holds ``lr * dH``; ``(chunks, B, 1)``, the loss sums alone, without."""
    n = z.shape[0]
    trials, hidden = b1.shape
    n_out = b2.shape[1]
    zz = z.view(n, trials, hidden)
    h = torch.relu(zz + b1)
    logp = torch.log_softmax(torch.einsum("nbh,bho->nbo", h, w2) + b2, dim=-1)
    idx = labels.view(n, 1, 1).expand(n, trials, 1)
    nll = -torch.gather(logp, -1, idx).squeeze(-1)
    if lr is None:
        return torch.stack([c.sum(0) for c in nll.split(CHUNK_ROWS)]).unsqueeze(-1)
    onehot = torch.nn.functional.one_hot(labels, n_out).to(z.dtype).unsqueeze(1)
    g = (torch.exp(logp) - onehot) / n
    dh = torch.where(h > 0, torch.einsum("nbo,bho->nbh", g, w2), 0.0)
    parts = torch.stack([
        torch.cat([torch.einsum("nbh,nbo->bho", hc, gc).reshape(trials, hidden * n_out), gc.sum(0), dc.sum(0),
                   lc.sum(0).unsqueeze(-1)], dim=1)
        for hc, gc, dc, lc in zip(*(t.split(CHUNK_ROWS) for t in (h, g, dh, nll)))
    ])
    zz.copy_(dh * lr.view(1, trials, 1))
    return parts


@functools.cache
def _lib():
    """The built library of ``csrc/mlp_head.cu``, bound."""
    from optuna_tpu_torch.ops.kernels import _nvcc

    lib = _nvcc.load(_SOURCE, _bind)
    if lib.mlp_head_chunk_rows() != CHUNK_ROWS:
        raise _nvcc.KernelBuildError(f"{_SOURCE} sums {lib.mlp_head_chunk_rows()} rows a block, not {CHUNK_ROWS}.")
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the library's entry points; returns ``lib``."""
    fn = lib.mlp_head_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mlp_head_supports.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mlp_head_supports.restype = ctypes.c_int
    lib.mlp_head_chunk_rows.restype = ctypes.c_int
    return lib


def supports(hidden: int, n_out: int) -> bool:
    """Whether the kernel is built for these widths (builds it if need be)."""
    return bool(_lib().mlp_head_supports(hidden, n_out))


def _launch(z, b1, w2, b2, labels, lr) -> torch.Tensor:
    """The kernel's partials (see :func:`head_partials_plain`), counted in :data:`LAUNCHES`."""
    global LAUNCHES
    lib = _lib()
    dev = z.device
    n, trials, hidden, n_out = z.shape[0], b1.shape[0], b1.shape[-1], b2.shape[-1]
    tensors = {"z": z, "b1": b1, "w2": w2, "b2": b2, "labels": labels} | ({} if lr is None else {"lr": lr})
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"mlp_head: {name} is on {t.device}, z on {dev}.")
        if t.dtype != (torch.int64 if name == "labels" else torch.float32):
            raise TypeError(f"mlp_head: {name} has dtype {t.dtype}.")
    shapes = {"z": (n, trials * hidden), "b1": (trials, hidden), "w2": (trials, hidden, n_out),
              "b2": (trials, n_out), "labels": (n,), "lr": (trials,)}
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"mlp_head: {name} is {tuple(t.shape)}, expected {shapes[name]}.")
    if not z.is_contiguous() or z.data_ptr() % 16:
        raise ValueError("mlp_head: z must be contiguous and 16-byte aligned (it is written in place).")
    if not lib.mlp_head_supports(hidden, n_out) or trials > 65535:
        raise ValueError(f"mlp_head: no kernel for hidden {hidden}, {n_out} outputs, {trials} trials.")
    b1, w2, b2, labels = (t.contiguous() for t in (b1, w2, b2, labels))
    width = 1 if lr is None else hidden * n_out + n_out + hidden + 1
    parts = torch.empty((-(-n // CHUNK_ROWS), trials, width), dtype=torch.float32, device=dev)
    err = lib.mlp_head_launch(
        z.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), labels.data_ptr(),
        None if lr is None else lr.contiguous().data_ptr(), parts.data_ptr(), n, trials, hidden, n_out,
        int(lr is not None), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mlp_head kernel launch failed: CUDA error {err}.")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return parts


def _partials(z, b1, w2, b2, labels, lr) -> torch.Tensor:
    if z.device.type == "cuda":
        return _launch(z, b1, w2, b2, labels, lr)
    if z.device.type == "cpu":
        return head_partials_plain(z, b1, w2, b2, labels, lr)
    raise ValueError(f"mlp_head: unsupported device {z.device}.")


def _finish(parts: torch.Tensor, n: int, hidden: int, n_out: int) -> "HeadGrads | torch.Tensor":
    """The chunks' partials added in order: the losses, and the gradients
    where the partials hold them."""
    total = parts.sum(0)
    if total.shape[1] == 1:
        return total[:, 0] / n
    dw2, db2, db1, loss = total.split([hidden * n_out, n_out, hidden, 1], dim=1)
    return HeadGrads(loss[:, 0] / n, dw2.reshape(-1, hidden, n_out), db2, db1)


def head_step_plain(z, b1, w2, b2, labels, lr) -> HeadGrads:
    """:func:`head_step` in plain PyTorch on any device (the kernel's check)."""
    return _finish(head_partials_plain(z, b1, w2, b2, labels, lr), z.shape[0], b1.shape[1], b2.shape[1])


def head_loss_plain(z, b1, w2, b2, labels) -> torch.Tensor:
    """:func:`head_loss` in plain PyTorch on any device (the kernel's check)."""
    return _finish(head_partials_plain(z, b1, w2, b2, labels), z.shape[0], b1.shape[1], b2.shape[1])


def head_step(
    z: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, labels: torch.Tensor, lr: torch.Tensor
) -> HeadGrads:
    """The head of one SGD step of every trial. ``z`` is ``X @ W1``,
    ``(N, B*H)``, and is overwritten with ``lr * dH`` (trial ``b``'s rate on
    its column block); ``b1`` ``(B, H)``, ``w2`` ``(B, H, O)``, ``b2``
    ``(B, O)``, ``labels`` int64 ``(N,)`` in ``[0, O)``, ``lr`` ``(B,)``.
    Returns the losses before the step and the unscaled gradients of
    ``w2``, ``b2`` and ``b1``."""
    return _finish(_partials(z, b1, w2, b2, labels, lr), z.shape[0], b1.shape[1], b2.shape[1])


def head_loss(z: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of every trial, ``(B,)``; ``z`` is left as it is."""
    return _finish(_partials(z, b1, w2, b2, labels, None), z.shape[0], b1.shape[1], b2.shape[1])
