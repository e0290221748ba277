"""Mixture-of-product KDE over mixed search spaces — the TPE density model
(re-homed copy of ``optuna_tpu/samplers/_tpe/parzen_estimator.py``).

Parity target: ``optuna/samplers/_tpe/parzen_estimator.py:38`` (+ the
``_MixtureOfProductDistribution`` in ``probability_distributions.py:139-229``).

Host NumPy: the constants, the transformed bounds and decode, the
power-of-two component buckets, the weights check, and the host
``_ParzenEstimator`` that the build on the device
(:mod:`optuna_tpu_torch.samplers._tpe._kernels`) is held against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)

EPS = 1e-12

#: Zero-variance bandwidth floor, as a fraction of the (transformed) domain
#: width. With magic clip disabled the reference floors sigma at EPS, which
#: for an all-identical observation set (constant objectives, retry clones)
#: collapses the KDE to a delta — tolerable in f64, degenerate on the f32
#: device path where the (x - mu)/sigma standardization explodes. Any
#: non-degenerate history has neighbor-gap sigmas orders of magnitude above
#: this floor, so only zero-variance dims feel it. The in-graph build
#: (:mod:`optuna_tpu_torch.samplers._tpe._kernels`) applies the identical floor —
#: the build-parity suite holds the two together.
SIGMA_DOMAIN_FLOOR = 1e-7


class _ParzenEstimatorParameters(NamedTuple):
    consider_prior: bool
    prior_weight: float
    consider_magic_clip: bool
    consider_endpoints: bool
    weights: Callable[[int], np.ndarray]
    multivariate: bool
    categorical_distance_func: dict[
        str, Callable[[object, object], float]
    ]


@dataclass
class _NumericalSpec:
    """Transformed-space description of one numerical dimension."""

    name: str
    low: float  # transformed (log applied when dist.log)
    high: float
    step: float  # 0.0 => continuous in transformed space
    is_log: bool
    dist: BaseDistribution


@dataclass
class _CategoricalSpec:
    name: str
    n_choices: int
    dist: CategoricalDistribution


def _transformed_bounds(dist: BaseDistribution) -> tuple[float, float, float, bool]:
    """(low, high, step, is_log) in the KDE's working space.

    Ints get half-step widening so every grid point carries equal mass;
    log domains move to log space and are treated as continuous there
    (rounded back at decode time), matching the reference's handling.
    """
    if isinstance(dist, FloatDistribution):
        if dist.log:
            return math.log(dist.low), math.log(dist.high), 0.0, True
        if dist.step is not None:
            half = 0.5 * dist.step
            return dist.low - half, dist.high + half, float(dist.step), False
        return dist.low, dist.high, 0.0, False
    assert isinstance(dist, IntDistribution)
    if dist.log:
        return math.log(dist.low - 0.5), math.log(dist.high + 0.5), 0.0, True
    half = 0.5 * dist.step
    return dist.low - half, dist.high + half, float(dist.step), False


def _to_transformed(dist: BaseDistribution, internal: np.ndarray) -> np.ndarray:
    if getattr(dist, "log", False):
        return np.log(internal)
    return internal.astype(np.float64)


def _from_transformed(dist: BaseDistribution, value: float) -> float:
    """Decode one transformed sample back to an *internal* representation."""
    if isinstance(dist, FloatDistribution):
        if dist.log:
            value = math.exp(value)
        elif dist.step is not None:
            value = dist.low + dist.step * round((value - dist.low) / dist.step)
        return float(min(max(value, dist.low), dist.high))
    assert isinstance(dist, IntDistribution)
    if dist.log:
        value = math.exp(value)
        v = int(round(value))
    else:
        v = int(dist.low + dist.step * round((value - dist.low) / dist.step))
    v = min(max(v, dist.low), dist.high)
    v = dist.low + ((v - dist.low) // dist.step) * dist.step
    return float(v)


def _bucket(n: int) -> int:
    """Pad component counts to powers of two (>=4), as the reference does."""
    return max(4, 1 << (n - 1).bit_length())


class _ParzenEstimator:
    """Weighted product-KDE over a (possibly mixed) search space."""

    def __init__(
        self,
        observations: dict[str, np.ndarray],
        search_space: dict[str, BaseDistribution],
        parameters: _ParzenEstimatorParameters,
        predetermined_weights: np.ndarray | None = None,
    ) -> None:
        if len(search_space) == 0:
            raise ValueError("Search space must not be empty.")
        self._search_space = search_space

        n = len(next(iter(observations.values()))) if observations else 0
        if predetermined_weights is not None:
            assert n == len(predetermined_weights)
        weights = (
            predetermined_weights
            if predetermined_weights is not None
            else _call_weights_func(parameters.weights, n)
        )
        if n == 0:
            # No observations: the KDE degenerates to the prior alone.
            consider_prior = True
        else:
            consider_prior = parameters.consider_prior
        n_components = n + (1 if consider_prior else 0)
        if consider_prior:
            weights = np.append(weights, [parameters.prior_weight])
        weights = weights.astype(np.float64)
        weights /= weights.sum()

        self._num_specs: list[_NumericalSpec] = []
        self._cat_specs: list[_CategoricalSpec] = []
        num_mus: list[np.ndarray] = []
        num_sigmas: list[np.ndarray] = []
        cat_probs: list[np.ndarray] = []

        for name, dist in search_space.items():
            obs = np.asarray(observations[name], dtype=np.float64) if n > 0 else np.empty(0)
            if isinstance(dist, CategoricalDistribution):
                spec = _CategoricalSpec(name, len(dist.choices), dist)
                self._cat_specs.append(spec)
                cat_probs.append(
                    self._categorical_probs(obs.astype(np.int64), spec, parameters, consider_prior)
                )
            else:
                low, high, step, is_log = _transformed_bounds(dist)
                spec = _NumericalSpec(name, low, high, step, is_log, dist)
                self._num_specs.append(spec)
                mus = _to_transformed(dist, obs)
                mu, sigma = self._numerical_mus_sigmas(mus, spec, parameters, consider_prior)
                num_mus.append(mu)
                num_sigmas.append(sigma)

        # --- pad to the component bucket -------------------------------
        B = _bucket(n_components)
        log_w = np.full(B, -np.inf)
        log_w[:n_components] = np.log(np.maximum(weights, EPS))

        Dn = len(self._num_specs)
        Dc = len(self._cat_specs)
        self._n_components = n_components
        self._log_weights = log_w
        self._mus = np.zeros((B, Dn))
        self._sigmas = np.ones((B, Dn))
        for d in range(Dn):
            self._mus[:n_components, d] = num_mus[d]
            self._sigmas[:n_components, d] = num_sigmas[d]
        self._lows = np.array([s.low for s in self._num_specs], dtype=np.float64)
        self._highs = np.array([s.high for s in self._num_specs], dtype=np.float64)
        self._steps = np.array([s.step for s in self._num_specs], dtype=np.float64)

        Cmax = max((s.n_choices for s in self._cat_specs), default=1)
        self._cat_log_probs = np.full((B, Dc, Cmax), -np.inf)
        for d, probs in enumerate(cat_probs):
            self._cat_log_probs[:n_components, d, : probs.shape[1]] = np.log(
                np.maximum(probs, EPS)
            )

    # ---------------------------------------------------------------- builders

    def _numerical_mus_sigmas(
        self,
        mus: np.ndarray,
        spec: _NumericalSpec,
        parameters: _ParzenEstimatorParameters,
        consider_prior: bool,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Reference bandwidth logic (`parzen_estimator.py:186-216`):
        neighbor-distance sigmas (for multivariate KDEs too — the reference
        has no separate multivariate bandwidth branch), then the
        "magic clip"."""
        n = len(mus)
        low, high = spec.low, spec.high
        prior_mu = 0.5 * (low + high)
        prior_sigma = 1.0 * (high - low)

        if n == 0:
            sigmas = np.empty(0)
        else:
            # Max distance to the neighbors in sorted order, endpoints included.
            sorted_indices = np.argsort(mus)
            sorted_mus = np.empty(n + 2)
            sorted_mus[0] = low
            sorted_mus[1:-1] = mus[sorted_indices]
            sorted_mus[-1] = high
            sorted_sigmas = np.maximum(
                sorted_mus[1:-1] - sorted_mus[0:-2], sorted_mus[2:] - sorted_mus[1:-1]
            )
            if not parameters.consider_endpoints and n >= 2:
                sorted_sigmas[0] = sorted_mus[2] - sorted_mus[1]
                sorted_sigmas[-1] = sorted_mus[-2] - sorted_mus[-3]
            sigmas = sorted_sigmas[np.argsort(sorted_indices)]

        maxsigma = 1.0 * (high - low)
        if parameters.consider_magic_clip:
            n_k = n + (1 if consider_prior else 0)
            minsigma = 1.0 * (high - low) / min(100.0, 1.0 + n_k)
        else:
            minsigma = EPS
        sigmas = np.asarray(np.clip(sigmas, minsigma, maxsigma))
        sigmas = np.maximum(sigmas, SIGMA_DOMAIN_FLOOR * (high - low))

        if consider_prior:
            mus = np.append(mus, prior_mu)
            sigmas = np.append(sigmas, prior_sigma)
        return mus, sigmas

    def _categorical_probs(
        self,
        obs_indices: np.ndarray,
        spec: _CategoricalSpec,
        parameters: _ParzenEstimatorParameters,
        consider_prior: bool,
    ) -> np.ndarray:
        """Smoothed one-hot weight tables (`parzen_estimator.py:132-166`),
        optionally kernelized by a user distance function."""
        n = len(obs_indices)
        n_components = n + (1 if consider_prior else 0)
        C = spec.n_choices
        dist_func = parameters.categorical_distance_func.get(spec.name)

        probs = np.full((n_components, C), parameters.prior_weight / max(n_components, 1))
        if dist_func is None:
            probs[np.arange(n), obs_indices] += 1.0
        elif n > 0:
            # Distance kernel (reference `parzen_estimator.py:152-160`): rows
            # are *replaced* by exp(-(d/row_max)^2 * coef) with
            # coef = log(n_kernels/prior_weight) * log(C) / log(6).
            choices = spec.dist.choices
            used, rev = np.unique(obs_indices, return_inverse=True)
            dists = np.array(
                [[float(dist_func(choices[int(i)], c)) for c in choices] for i in used]
            )
            coef = (
                np.log(max(n_components, 1) / parameters.prior_weight) * np.log(C) / np.log(6)
            )
            row_max = np.maximum(np.max(dists, axis=1, keepdims=True), EPS)
            probs[:n] = np.exp(-((dists / row_max) ** 2) * coef)[rev]
        row_sums = probs.sum(axis=1, keepdims=True)
        probs /= np.where(row_sums == 0, 1.0, row_sums)
        return probs

    # ---------------------------------------------------------------- device IO

    def pack(self) -> dict[str, np.ndarray]:
        """Padded arrays in the layout of the device mixture."""
        return {
            "log_weights": self._log_weights,
            "mus": self._mus,
            "sigmas": self._sigmas,
            "lows": self._lows,
            "highs": self._highs,
            "steps": self._steps,
            "cat_log_probs": self._cat_log_probs,
        }

    @property
    def num_specs(self) -> list[_NumericalSpec]:
        return self._num_specs

    @property
    def cat_specs(self) -> list[_CategoricalSpec]:
        return self._cat_specs

    def decode(self, num_sample: np.ndarray, cat_sample: np.ndarray) -> dict[str, float]:
        """One transformed sample -> dict of internal representations."""
        out: dict[str, float] = {}
        for d, spec in enumerate(self._num_specs):
            out[spec.name] = _from_transformed(spec.dist, float(num_sample[d]))
        for d, spec in enumerate(self._cat_specs):
            out[spec.name] = float(int(cat_sample[d]))
        return out


def _call_weights_func(weights_func: Callable[[int], np.ndarray], n: int) -> np.ndarray:
    w = np.asarray(weights_func(n), dtype=np.float64)
    if w.shape != (n,):
        raise ValueError(f"The weights function must return a 1-d array of length {n}.")
    if np.any(w < 0) or (n > 0 and not np.all(np.isfinite(w))) or (n > 0 and w.sum() <= 0):
        raise ValueError("The weights function must return non-negative finite weights.")
    return w
