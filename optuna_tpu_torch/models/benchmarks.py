"""Benchmark objectives (port of ``optuna_tpu/models/benchmarks.py``).

This slice carries Hartmann-20D, BASELINE.md configuration #2: Hartmann-6 on
the first six of twenty unit-interval parameters, the other fourteen inert.
"""

from __future__ import annotations

import numpy as np

_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
_H6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)


def hartmann6_np(x: np.ndarray) -> np.ndarray:
    """Batched Hartmann-6 over the first six columns of ``x`` (n, >=6)."""
    x6 = np.asarray(x, dtype=np.float64)[:, :6]
    inner = np.sum(_H6_A[None] * (x6[:, None, :] - _H6_P[None]) ** 2, axis=-1)
    return -np.sum(_H6_ALPHA[None] * np.exp(-inner), axis=-1)


def hartmann20(trial) -> float:
    """20D embedding of Hartmann6 (extra dims are inert), the BASELINE #2
    configuration's common construction."""
    x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(20)])
    x6 = x[:6]
    inner = np.sum(_H6_A * (x6[None, :] - _H6_P) ** 2, axis=1)
    return float(-np.sum(_H6_ALPHA * np.exp(-inner)))
