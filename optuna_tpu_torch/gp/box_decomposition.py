"""Disjoint box decomposition of the non-dominated region (for EHVI).

A copy of ``optuna_tpu/gp/box_decomposition.py`` (BoTorch-derived, Lacour
et al. 2017), re-homed so the port imports nothing of the reference.
Host-side NumPy, run once per ask: the box set goes to the device, where
the per-candidate EHVI reduction runs in the acquisition.

Convention: minimization. The non-dominated region w.r.t. Pareto set P and
reference point ``ref`` is  {z : z <= ref, no p in P with p <= z}; it is
partitioned into disjoint axis-aligned boxes by recursive first-coordinate
slicing at the Pareto points' coordinates.
"""

from __future__ import annotations

import numpy as np


def _pareto_min(points: np.ndarray) -> np.ndarray:
    """Non-dominated subset under minimization."""
    if len(points) <= 1:
        return points
    points = np.unique(points, axis=0)
    leq = np.all(points[:, None, :] <= points[None, :, :], axis=2)
    lt = np.any(points[:, None, :] < points[None, :, :], axis=2)
    dominated = np.any(leq & lt, axis=0)
    return points[~dominated]


def _decompose(P: np.ndarray, lower: np.ndarray, upper: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    m = len(lower)
    if np.any(lower >= upper):
        return []
    if len(P) == 0:
        return [(lower.copy(), upper.copy())]
    if m == 1:
        hi = min(float(P.min()), float(upper[0]))
        if lower[0] < hi:
            return [(lower.copy(), np.array([hi]))]
        return []

    cuts = np.unique(P[:, 0])
    cuts = cuts[(cuts > lower[0]) & (cuts < upper[0])]
    edges = np.concatenate(([lower[0]], cuts, [upper[0]]))
    boxes: list[tuple[np.ndarray, np.ndarray]] = []
    for a, b in zip(edges[:-1], edges[1:]):
        if a >= b:
            continue
        # Points with first coordinate <= a dominate throughout this slab.
        active = P[P[:, 0] <= a][:, 1:]
        active = _pareto_min(active) if len(active) else active
        for sl, su in _decompose(active, lower[1:], upper[1:]):
            boxes.append(
                (np.concatenate(([a], sl)), np.concatenate(([b], su)))
            )
    return boxes


def nondominated_box_decomposition(
    pareto_vals: np.ndarray, reference_point: np.ndarray, max_boxes: int = 1024
) -> tuple[np.ndarray, np.ndarray]:
    """(lowers (K, m), uppers (K, m)) partitioning the non-dominated region.

    ``pareto_vals`` need not be pre-filtered. The lower corner of the region
    is pushed well below the observed values so the boxes cover everything a
    posterior sample can realistically reach.
    """
    pareto_vals = np.asarray(pareto_vals, dtype=np.float64)
    reference_point = np.asarray(reference_point, dtype=np.float64)
    P = _pareto_min(pareto_vals)
    span = np.maximum(reference_point - P.min(axis=0), 1.0)
    lower = P.min(axis=0) - 10.0 * span
    boxes = _decompose(P, lower, reference_point.copy())
    if len(boxes) == 0:
        return (
            lower[None, :],
            reference_point[None, :],
        )
    lowers = np.stack([b[0] for b in boxes])
    uppers = np.stack([b[1] for b in boxes])
    if len(lowers) > max_boxes:
        # Box count grows ~|P|^(m-1); cap the device tensor by keeping the
        # largest-volume cells (small bias toward under-estimating EHVI in
        # the dropped slivers, bounded HBM in exchange).
        vol = np.prod(np.minimum(uppers, reference_point) - np.maximum(lowers, P.min(axis=0) - span), axis=1)
        keep = np.argsort(vol)[::-1][:max_boxes]
        lowers, uppers = lowers[keep], uppers[keep]
    return lowers, uppers
