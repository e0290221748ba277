"""Crossover operators for NSGA-II/III.

Parity target: ``optuna/samplers/nsgaii/_crossovers/*.py`` (uniform, BLX-α,
SPX, SBX, vSBX, UNDX) + the dispatch in ``nsgaii/_crossover.py:84``.
Operators act on search-space-transformed continuous vectors; categorical
dims are inherited uniformly from parents by the caller.
"""

from __future__ import annotations

import abc

import numpy as np


class BaseCrossover(abc.ABC):
    n_parents: int = 2

    @abc.abstractmethod
    def crossover(
        self,
        parents_params: np.ndarray,  # (n_parents, d) transformed
        rng: np.random.RandomState,
        search_space_bounds: np.ndarray,  # (d, 2)
    ) -> np.ndarray:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.__class__.__name__


class UniformCrossover(BaseCrossover):
    """Each gene from either parent with probability ``swapping_prob``."""

    n_parents = 2

    def __init__(self, swapping_prob: float = 0.5) -> None:
        if not 0.0 <= swapping_prob <= 1.0:
            raise ValueError("`swapping_prob` must be in [0, 1].")
        self._swapping_prob = swapping_prob

    def crossover(self, parents_params, rng, search_space_bounds):
        take_second = rng.rand(parents_params.shape[1]) < self._swapping_prob
        return np.where(take_second, parents_params[1], parents_params[0])


class BLXAlphaCrossover(BaseCrossover):
    """Blend crossover: uniform in the per-gene interval widened by alpha."""

    n_parents = 2

    def __init__(self, alpha: float = 0.5) -> None:
        self._alpha = alpha

    def crossover(self, parents_params, rng, search_space_bounds):
        lo = parents_params.min(axis=0)
        hi = parents_params.max(axis=0)
        diff = self._alpha * (hi - lo)
        child = rng.uniform(lo - diff, hi + diff)
        return child


class SPXCrossover(BaseCrossover):
    """Simplex crossover over n_parents=3 (Tsutsui et al.)."""

    n_parents = 3

    def __init__(self, epsilon: float | None = None) -> None:
        self._epsilon = epsilon

    def crossover(self, parents_params, rng, search_space_bounds):
        n = parents_params.shape[0]
        epsilon = self._epsilon if self._epsilon is not None else np.sqrt(n + 2)
        G = parents_params.mean(axis=0)
        rs = [rng.rand() ** (1.0 / (k + 1)) for k in range(n - 1)]
        xks = G + epsilon * (parents_params - G)
        c = np.zeros_like(G)
        for k in range(1, n):
            c = rs[k - 1] * (xks[k - 1] - xks[k] + c)
        return xks[-1] + c


class SBXCrossover(BaseCrossover):
    """Simulated binary crossover with distribution index eta."""

    n_parents = 2

    def __init__(self, eta: float | None = None) -> None:
        self._eta = eta

    def crossover(self, parents_params, rng, search_space_bounds):
        x1, x2 = parents_params[0], parents_params[1]
        d = len(x1)
        eta = self._eta if self._eta is not None else 2.0
        xl = search_space_bounds[:, 0]
        xu = search_space_bounds[:, 1]
        u = rng.rand(d)
        beta = np.where(
            u <= 0.5,
            (2 * u) ** (1.0 / (eta + 1)),
            (1.0 / (2 * (1 - u))) ** (1.0 / (eta + 1)),
        )
        c1 = 0.5 * ((1 + beta) * x1 + (1 - beta) * x2)
        c2 = 0.5 * ((1 - beta) * x1 + (1 + beta) * x2)
        child = np.where(rng.rand(d) < 0.5, c1, c2)
        return np.clip(child, xl, xu)


class VSBXCrossover(BaseCrossover):
    """Modified (vectorized-bounds) SBX that can escape parent span."""

    n_parents = 2

    def __init__(self, eta: float | None = None) -> None:
        self._eta = eta

    def crossover(self, parents_params, rng, search_space_bounds):
        x1, x2 = parents_params[0], parents_params[1]
        d = len(x1)
        eta = self._eta if self._eta is not None else 2.0
        u = rng.rand(d)
        beta_1 = np.power(1 / np.clip(2 * u, 1e-12, None), 1 / (eta + 1))
        beta_2 = np.power(1 / np.clip(2 * (1 - u), 1e-12, None), 1 / (eta + 1))
        mask = u <= 0.5
        c1 = np.where(mask, 0.5 * ((1 + beta_1) * x1 + (1 - beta_1) * x2), 0.5 * ((3 - beta_2) * x1 - (1 - beta_2) * x2))
        c2 = np.where(mask, 0.5 * ((1 - beta_1) * x1 + (1 + beta_1) * x2), 0.5 * (-(1 - beta_2) * x1 + (3 - beta_2) * x2))
        child = np.where(rng.rand(d) < 0.5, c1, c2)
        return np.clip(child, search_space_bounds[:, 0], search_space_bounds[:, 1])


class UNDXCrossover(BaseCrossover):
    """Unimodal normal distribution crossover (n_parents=3)."""

    n_parents = 3

    def __init__(self, sigma_xi: float = 0.5, sigma_eta: float | None = None) -> None:
        self._sigma_xi = sigma_xi
        self._sigma_eta = sigma_eta

    def crossover(self, parents_params, rng, search_space_bounds):
        x1, x2, x3 = parents_params
        d = len(x1)
        xp = 0.5 * (x1 + x2)
        diff = x2 - x1
        norm_diff = np.linalg.norm(diff)
        sigma_eta = self._sigma_eta if self._sigma_eta is not None else 0.35 / np.sqrt(d)
        # Distance of x3 from the line x1-x2.
        if norm_diff > 0:
            e1 = diff / norm_diff
            proj = np.dot(x3 - x1, e1)
            dist_vec = (x3 - x1) - proj * e1
            D = np.linalg.norm(dist_vec)
        else:
            e1 = np.zeros(d)
            D = np.linalg.norm(x3 - x1)
        xi = rng.normal(0, self._sigma_xi)
        child = xp + xi * diff
        etas = rng.normal(0, sigma_eta, size=d) * D
        # Remove the component along e1.
        etas = etas - np.dot(etas, e1) * e1
        return child + etas


_CROSSOVERS = {
    "uniform": UniformCrossover,
    "blxalpha": BLXAlphaCrossover,
    "spx": SPXCrossover,
    "sbx": SBXCrossover,
    "vsbx": VSBXCrossover,
    "undx": UNDXCrossover,
}


def get_crossover(name: str) -> BaseCrossover:
    if name not in _CROSSOVERS:
        raise ValueError(f"Unknown crossover {name!r}; choose from {sorted(_CROSSOVERS)}.")
    return _CROSSOVERS[name]()
