"""Numerical guards of the sampler path (port of the in-graph ring and the
host conditioners of ``optuna_tpu/samplers/_resilience.py``).

* :func:`ladder_cholesky_with_rung` — Cholesky with escalating diagonal
  jitter; the single Cholesky call site for sampler code.
* :func:`ladder_cholesky_rank1_update` — append one observation's row to a
  ladder factor in O(n²), with a full-refactorization fallback.
* :func:`ladder_cholesky_rank1_raise` — additive rank-1 update of a ladder
  factor with a full-refactorization fallback.
* :func:`clip_objective_values`, :func:`collapse_duplicate_rows` — host-side
  degenerate-history conditioners applied before standardization.

The reference runs its ladders as ``lax.while_loop``/``lax.cond`` with the
health verdict on the device. Here each verdict is read to the host once per
call (one sync per ladder), and the loops are Python loops. The
``GuardedSampler`` containment wrapper comes with a later slice.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_F32_MAX = float(np.finfo(np.float32).max)

#: Jitter ladder: multiples of the Gram diagonal scale tried in order until
#: the factor is good. The first rung (0) is the bare matrix — the happy
#: path costs exactly one factorization.
_LADDER_INITIAL_JITTER = 1e-6
_LADDER_GROWTH = 100.0
_LADDER_MAX_RUNGS = 4


def _factor(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, ok): ``torch.linalg.cholesky_ex`` can hand back a finite but wrong
    partial factor with ``info > 0`` where JAX returns NaN, so a factor is
    good only when ``info == 0`` *and* every entry is finite."""
    L, info = torch.linalg.cholesky_ex(K)
    return L, (info == 0) & torch.all(torch.isfinite(L))


def ladder_cholesky_with_rung(
    K: torch.Tensor, *, initial_jitter: float = _LADDER_INITIAL_JITTER
) -> tuple[torch.Tensor, int]:
    """Factor ``K`` as-is, and while the factor is bad escalate additive
    diagonal jitter (``initial_jitter · 100^rung`` of the diagonal scale) and
    refactor, at most ``_LADDER_MAX_RUNGS`` times. Returns ``(L, rung)``:
    ``rung`` counts the escalation refactorizations, 0 when the bare matrix
    factored. If every rung fails, ``L`` is NaN, as the reference's is.
    2-D matrices only."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    # Jitter scales with the matrix, floored at 1.0 so an all-zero Gram
    # (possible when every row collapsed to the origin) still regularizes.
    scale = torch.clamp(torch.max(torch.abs(torch.diagonal(K))), min=1.0)
    L, ok = _factor(K)
    rung = 0
    while rung < _LADDER_MAX_RUNGS and not bool(ok):
        jitter = initial_jitter * (_LADDER_GROWTH**rung) * scale
        L, ok = _factor(K + eye * jitter)
        rung += 1
    if not bool(ok):
        L = torch.full_like(L, float("nan"))
    return L, rung


def ladder_cholesky(K: torch.Tensor, *, initial_jitter: float = _LADDER_INITIAL_JITTER):
    """:func:`ladder_cholesky_with_rung` without the rung."""
    L, _ = ladder_cholesky_with_rung(K, initial_jitter=initial_jitter)
    return L


#: Relative pivot floor for the incremental update: below this fraction of
#: the new row's own diagonal the Schur complement is numerically spent
#: (f32 eps is ~1.2e-7; duplicates under a deterministic noise floor land
#: here) and the factor falls back to a full jitter-ladder refactorization.
_RANK1_PIVOT_RTOL = 1e-6


def ladder_cholesky_rank1_update(
    L: torch.Tensor,
    k_row: torch.Tensor,
    slot: int,
    kernel_fn: Callable[[], torch.Tensor],
    *,
    initial_jitter: float = _LADDER_INITIAL_JITTER,
) -> tuple[torch.Tensor, int, int]:
    """Extend a ladder-Cholesky factor by one observation in O(n²) instead
    of refactorizing the whole Gram in O(n³): the scan loop's per-tell
    update.

    ``L`` is the (N, N) lower factor of the padded kernel whose rows
    ``< slot`` are real observations (appends are in slot order, so every
    row ``>= slot`` is padding). ``k_row`` is row ``slot`` of the extended
    kernel: cross-covariances against the buffer plus the noise-carrying
    diagonal at position ``slot``. A Cholesky factor's leading block depends
    only on the leading block of the matrix, so the append touches one row:
    one triangular solve for its off-diagonal entries and one Schur pivot
    for its diagonal. Padding rows keep their stale, decoupled entries.

    The pivot is the update's verdict, read to the host once: a non-finite
    or near-zero Schur complement (an exact-duplicate row under a
    deterministic noise floor) falls back to a full
    :func:`ladder_cholesky_with_rung` of ``kernel_fn()``, built only on that
    branch. Returns ``(L_new, rung, refactored)``; ``rung`` is 0 on the
    incremental path, ``refactored`` is 0 or 1.
    """
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    before = idx < slot
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    k_masked = torch.where(before, k_row, zero)
    l_off = torch.linalg.solve_triangular(L, k_masked[:, None], upper=False)[:, 0]
    l_off = torch.where(before, l_off, zero)
    diag = k_row[slot]
    pivot = diag - torch.sum(l_off * l_off)
    ok = (
        torch.all(torch.isfinite(l_off))
        & torch.isfinite(pivot)
        & (pivot > _RANK1_PIVOT_RTOL * torch.abs(diag))
    )
    if bool(ok):
        new_row = torch.where(idx == slot, torch.sqrt(torch.clamp(pivot, min=1e-30)), l_off)
        return torch.where((idx == slot)[:, None], new_row[None, :], L), 0, 0
    L_new, rung = ladder_cholesky_with_rung(kernel_fn(), initial_jitter=initial_jitter)
    return L_new, rung, 1


def ladder_cholesky_rank1_raise(
    L: torch.Tensor,
    v: torch.Tensor,
    kernel_fn: Callable[[], torch.Tensor],
    *,
    initial_jitter: float = _LADDER_INITIAL_JITTER,
) -> tuple[torch.Tensor, int, int]:
    """The ``L'`` with ``L'L'ᵀ = LLᵀ + vvᵀ`` in O(n²): the LINPACK ``dchud``
    sweep, one Givens-style rotation per column.

    The additive update of a positive-definite matrix cannot lose
    positivity, so a non-finite entry or non-positive diagonal after the
    sweep means f32 round-off on an ill-conditioned factor; the factor then
    falls back to a full :func:`ladder_cholesky_with_rung` of
    ``kernel_fn()`` (built only on that branch). Returns
    ``(L_new, rung, refactored)``; ``rung`` is 0 on the incremental path."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    Lc = L.clone()
    w = v.clone()
    for k in range(n):
        lkk = Lc[k, k]
        wk = w[k]
        r = torch.sqrt(lkk * lkk + wk * wk)
        c = r / lkk
        s = wk / lkk
        col = Lc[:, k]
        below = idx > k
        new_col = torch.where(below, (col + s * w) / c, col)
        new_col = torch.where(idx == k, r, new_col)
        w = torch.where(below, c * w - s * new_col, w)
        Lc[:, k] = new_col
    ok = torch.all(torch.isfinite(Lc)) & torch.all(torch.diagonal(Lc) > 0)
    if bool(ok):
        return Lc, 0, 0
    L_new, rung = ladder_cholesky_with_rung(kernel_fn(), initial_jitter=initial_jitter)
    return L_new, rung, 1


def clip_objective_values(values: np.ndarray) -> np.ndarray:
    """Clip ``±inf`` (and beyond-float32 magnitudes like ``1e308``) to the
    float32 extremes so a mean/std standardization stays finite end to end."""
    return np.clip(values, -_F32_MAX, _F32_MAX)


def collapse_duplicate_rows(
    X: np.ndarray, y: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse exact-duplicate design rows to one row with a count weight.

    Returns ``(X_unique, y_mean, counts)`` with first-occurrence order
    preserved; duplicate groups average their targets and carry the group
    size in ``counts``. Duplicate-free input is returned unchanged.
    """
    n = len(X)
    ones = np.ones(n, dtype=np.float32)
    if n == 0:
        return X, y, ones
    uniq, first, inverse, counts = np.unique(
        X, axis=0, return_index=True, return_inverse=True, return_counts=True
    )
    if len(uniq) == n:
        return X, y, ones
    order = np.argsort(first)  # chronological (first-occurrence) order
    sums = np.zeros(len(uniq), dtype=np.result_type(y.dtype, np.float32))
    np.add.at(sums, inverse, y)
    y_mean = (sums / counts)[order].astype(y.dtype)
    return (
        uniq[order].astype(X.dtype),
        y_mean,
        counts[order].astype(np.float32),
    )
