"""Benchmark objectives (port of ``optuna_tpu/models/benchmarks.py``).

The port carries Branin, BASELINE.md configuration #1 (TPE); Hartmann-20D,
configuration #2: Hartmann-6 on the first six of twenty unit-interval
parameters, the other fourteen inert, as a define-by-run objective and as
the batched objectives of the scan loop (``hartmann6_torch``,
``hartmann20_torch``); 50-D Rastrigin, configuration #3 (CMA-ES); ZDT1-3,
configuration #4's two-objective problems; and ``highdim_mixed``, the 30-parameter mixed space of ``bench.py --config
tpe_highdim``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------- Branin (2D)

_BRANIN_A = 1.0
_BRANIN_B = 5.1 / (4 * math.pi**2)
_BRANIN_C = 5 / math.pi
_BRANIN_R = 6.0
_BRANIN_S = 10.0
_BRANIN_T = 1 / (8 * math.pi)


def branin(trial) -> float:
    x1 = trial.suggest_float("x1", -5.0, 10.0)
    x2 = trial.suggest_float("x2", 0.0, 15.0)
    return (
        _BRANIN_A * (x2 - _BRANIN_B * x1**2 + _BRANIN_C * x1 - _BRANIN_R) ** 2
        + _BRANIN_S * (1 - _BRANIN_T) * math.cos(x1)
        + _BRANIN_S
    )


# ------------------------------------------------------------- Hartmann6 (6D)

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


def hartmann6(trial) -> float:
    x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(6)])
    inner = np.sum(_H6_A * (x[None, :] - _H6_P) ** 2, axis=1)
    return float(-np.sum(_H6_ALPHA * np.exp(-inner)))


def hartmann6_np(x: np.ndarray) -> np.ndarray:
    """Batched Hartmann-6 over the first six columns of ``x`` (n, >=6)."""
    x6 = np.asarray(x, dtype=np.float64)[:, :6]
    inner = np.sum(_H6_A[None] * (x6[:, None, :] - _H6_P[None]) ** 2, axis=-1)
    return -np.sum(_H6_ALPHA[None] * np.exp(-inner), axis=-1)


@functools.cache
def _h6_constants(device: torch.device, dtype: torch.dtype):
    """(alpha, A, P) of Hartmann-6 on ``device``, uploaded once per device."""
    return tuple(torch.as_tensor(c, dtype=dtype, device=device) for c in (_H6_ALPHA, _H6_A, _H6_P))


def hartmann6_torch(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Batched Hartmann-6 (the ``VectorizedObjective`` convention:
    ``{name: (B,)}`` -> ``(B,)``), computed in the inputs' dtype on their
    device: the twin of the reference's ``hartmann6_jax``."""
    x = torch.stack([params[f"x{i}"] for i in range(6)], dim=-1)  # (B, 6)
    alpha, a, p = _h6_constants(x.device, x.dtype)
    inner = torch.sum(a[None] * (x[:, None, :] - p[None]) ** 2, dim=-1)
    return -torch.sum(alpha[None] * torch.exp(-inner), dim=-1)


def hartmann20_torch(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Batched Hartmann-20: the 20D embedding's extra dims are inert, so this
    is the Hartmann-6 kernel reading ``x0``..``x5``."""
    return hartmann6_torch(params)


def hartmann20(trial) -> float:
    """20D embedding of Hartmann6 (extra dims are inert), the BASELINE #2
    configuration's common construction."""
    x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(20)])
    x6 = x[:6]
    inner = np.sum(_H6_A * (x6[None, :] - _H6_P) ** 2, axis=1)
    return float(-np.sum(_H6_ALPHA * np.exp(-inner)))


# ------------------------------------------------------------- Rastrigin (nD)


def rastrigin(trial, dim: int = 50) -> float:
    x = np.array([trial.suggest_float(f"x{i}", -5.12, 5.12) for i in range(dim)])
    return float(10 * dim + np.sum(x**2 - 10 * np.cos(2 * np.pi * x)))


# ------------------------------------------------------------------ ZDT (2-obj)


def _zdt_g(xs: np.ndarray) -> float:
    return 1 + 9 * float(np.sum(xs[1:])) / (len(xs) - 1)


def zdt1(trial, dim: int = 30):
    xs = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(dim)])
    g = _zdt_g(xs)
    f1 = float(xs[0])
    return f1, g * (1 - math.sqrt(f1 / g))


def zdt2(trial, dim: int = 30):
    xs = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(dim)])
    g = _zdt_g(xs)
    f1 = float(xs[0])
    return f1, g * (1 - (f1 / g) ** 2)


def zdt3(trial, dim: int = 30):
    xs = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(dim)])
    g = _zdt_g(xs)
    f1 = float(xs[0])
    return f1, g * (1 - math.sqrt(f1 / g) - (f1 / g) * math.sin(10 * math.pi * f1))


# -------------------------------------------------- high-dim mixed space


def highdim_mixed(trial) -> float:
    """30-parameter mixed search space: 15 uniform floats, 5 log floats, 5
    ints in [1, 64] and 5 four-way categoricals. The per-trial sampler cost
    at a realistic HPO width: univariate TPE samples every dimension in one
    batched device program."""
    total = 0.0
    for i in range(15):
        x = trial.suggest_float(f"x{i}", -3.0, 3.0)
        total += (x - 0.3 * (i % 5)) ** 2
    for i in range(5):
        lr = trial.suggest_float(f"log{i}", 1e-5, 1e-1, log=True)
        total += (math.log10(lr) + 2.0 + 0.2 * i) ** 2
    for i in range(5):
        k = trial.suggest_int(f"n{i}", 1, 64)
        total += 0.01 * (k - 8 * (i + 1)) ** 2
    for i in range(5):
        c = trial.suggest_categorical(f"c{i}", ["a", "b", "c", "d"])
        total += {"a": 0.0, "b": 0.3, "c": 0.6, "d": 0.9}[c]
    return total
