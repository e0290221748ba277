"""Exact hypervolume (minimization convention, dominated volume below ref point).

Parity target: ``optuna/_hypervolume/wfg.py``: dimension-specialized fast
paths (2D sweep ``:8``, 3D cumulative-min trick ``:16``) and the WFG
exclusive-hypervolume recursion for N-D (``:41-107``).

This host implementation is NumPy; the fixed-shape device versions live in
:mod:`optuna_tpu_torch.ops.wfg` and :mod:`optuna_tpu_torch.ops.hypervolume`
and are cross-checked against this one in tests.
"""

from __future__ import annotations

import numpy as np


def _compute_2d(sorted_pareto_sols: np.ndarray, reference_point: np.ndarray) -> float:
    """O(N) sweep over solutions pre-sorted by first objective (reference ``wfg.py:8``)."""
    rx, ry = reference_point
    hv = 0.0
    y_min = ry
    for x, y in sorted_pareto_sols:
        if y < y_min:
            hv += (rx - x) * (y_min - y)
            y_min = y
    return float(hv)


def _compute_3d(sorted_pareto_sols: np.ndarray, reference_point: np.ndarray) -> float:
    """O(N^2 log N) slicing (reference ``wfg.py:16-39``).

    For each point (in ascending first-coordinate order) the marginal (y,z)
    area it adds is ``area(prefix incl. point) - area(prefix)``; the previous
    iteration's inclusive area is carried forward so each step runs one 2D
    sweep, not two.
    """
    n = len(sorted_pareto_sols)
    hv = 0.0
    prev_area = 0.0
    pairs: list[tuple[float, float]] = []
    for i in range(n):
        x = sorted_pareto_sols[i]
        w = reference_point[0] - x[0]
        pairs.append((float(x[1]), float(x[2])))
        area_with = _compute_2d(np.asarray(sorted(pairs)), reference_point[1:])
        hv += w * (area_with - prev_area)
        prev_area = area_with
    return float(hv)


def _compute_exclusive_hv(
    limited_sols: np.ndarray, inclusive_hv: float, reference_point: np.ndarray
) -> float:
    if limited_sols.shape[0] == 0:
        return inclusive_hv
    return inclusive_hv - _compute_hv_recursive(limited_sols, reference_point)


def _compute_inclusive_hv(point: np.ndarray, reference_point: np.ndarray) -> float:
    return float(np.prod(reference_point - point))


def _compute_hv_recursive(sols: np.ndarray, reference_point: np.ndarray) -> float:
    """WFG recursion over exclusive hypervolumes (reference ``wfg.py:41-107``)."""
    n = sols.shape[0]
    if n == 0:
        return 0.0
    if n == 1:
        return _compute_inclusive_hv(sols[0], reference_point)
    if sols.shape[1] == 2:
        order = np.lexsort((-sols[:, 1], sols[:, 0]))
        return _compute_2d(sols[order], reference_point)

    hv = 0.0
    for i in range(n):
        point = sols[i]
        inclusive = _compute_inclusive_hv(point, reference_point)
        # limit: clamp the remaining points into the box dominated by `point`,
        # keep only the non-dominated among them.
        rest = sols[i + 1 :]
        if rest.shape[0] == 0:
            hv += inclusive
            continue
        limited = np.maximum(rest, point)
        limited = _pareto_filter(limited)
        hv += _compute_exclusive_hv(limited, inclusive, reference_point)
    return hv


def _pareto_filter(sols: np.ndarray) -> np.ndarray:
    """Unique non-dominated subset (minimization)."""
    sols = np.unique(sols, axis=0)
    n = len(sols)
    if n <= 1:
        return sols
    keep = np.ones(n, dtype=bool)
    leq = np.all(sols[:, None, :] <= sols[None, :, :], axis=2)
    lt = np.any(sols[:, None, :] < sols[None, :, :], axis=2)
    dominated = np.any(leq & lt, axis=0)
    keep &= ~dominated
    return sols[keep]


def compute_hypervolume(
    loss_vals: np.ndarray, reference_point: np.ndarray, assume_pareto: bool = False
) -> float:
    """Hypervolume dominated by ``loss_vals`` w.r.t. ``reference_point``
    (reference ``wfg.py:110``). Points beyond the reference point contribute 0."""
    loss_vals = np.asarray(loss_vals, dtype=np.float64)
    reference_point = np.asarray(reference_point, dtype=np.float64)
    if loss_vals.ndim != 2:
        raise ValueError("loss_vals must be 2-d (n_points, n_objectives).")
    if loss_vals.shape[1] != reference_point.shape[0]:
        raise ValueError("reference_point dimensionality mismatch.")
    if np.any(np.isnan(loss_vals)):
        raise ValueError("loss_vals must not contain NaN.")

    # Drop points that do not dominate the reference point anywhere.
    mask = np.all(loss_vals < reference_point, axis=1)
    loss_vals = loss_vals[mask]
    if loss_vals.shape[0] == 0:
        return 0.0
    if not assume_pareto:
        loss_vals = _pareto_filter(loss_vals)

    m = loss_vals.shape[1]
    if m == 1:
        return float(reference_point[0] - np.min(loss_vals[:, 0]))
    if m == 2:
        order = np.lexsort((-loss_vals[:, 1], loss_vals[:, 0]))
        return _compute_2d(loss_vals[order], reference_point)
    if m == 3:
        order = np.argsort(loss_vals[:, 0], kind="stable")
        return _compute_3d(loss_vals[order], reference_point)
    return _compute_hv_recursive(loss_vals, reference_point)
