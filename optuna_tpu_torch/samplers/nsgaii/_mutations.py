"""Pluggable NSGA-II mutation operators.

Parity target: ``optuna/samplers/nsgaii/_mutations/_base.py`` (protocol),
``_mutations/_polynomial.py:16`` (Deb's polynomial mutation, NSGA-II C code
rev 1.1.6), and the ``perform_mutation`` transformed-space plumbing in
``optuna/samplers/nsgaii/_mutation.py``. When no operator is given the
sampler keeps its default behavior — uniform resample of the gene — exactly
like the reference drops the parameter for independent resampling.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Any

import numpy as np

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    FloatDistribution,
    IntDistribution,
)
from optuna_tpu_torch.transform import SearchSpaceTransform

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class BaseMutation(abc.ABC):
    """Mutation protocol: perturb one numerical gene in transformed space."""

    def __str__(self) -> str:
        return self.__class__.__name__

    @abc.abstractmethod
    def mutation(
        self,
        param: float,
        rng: np.random.RandomState,
        study: "Study",
        search_space_bounds: np.ndarray,
    ) -> float:
        """Return the mutated value of ``param`` within ``(low, high)`` bounds."""
        raise NotImplementedError


class PolynomialMutation(BaseMutation):
    """Deb's polynomial mutation (reference ``_mutations/_polynomial.py:16``).

    Perturbs the gene by a polynomially-distributed delta; larger ``eta``
    concentrates children near the parent.
    """

    def __init__(self, eta: float = 20.0) -> None:
        if eta < 0:
            raise ValueError("`eta` must be a non-negative float value.")
        self._eta = eta

    def mutation(
        self,
        param: float,
        rng: np.random.RandomState,
        study: "Study",
        search_space_bounds: np.ndarray,
    ) -> float:
        u = rng.rand()
        lb, ub = search_space_bounds
        width = ub - lb
        if width <= 0.0:
            return param

        delta1 = (param - lb) / width
        delta2 = (ub - param) / width
        mutation_power = 1.0 / (self._eta + 1.0)
        if u <= 0.5:
            xy = 1.0 - delta1
            value = 2.0 * u + (1.0 - 2.0 * u) * xy ** (self._eta + 1.0)
            delta_q = value**mutation_power - 1.0
        else:
            xy = 1.0 - delta2
            value = 2.0 * (1.0 - u) + 2.0 * (u - 0.5) * xy ** (self._eta + 1.0)
            delta_q = 1.0 - value**mutation_power
        return param + delta_q * width


_NUMERICAL_DISTRIBUTIONS = (FloatDistribution, IntDistribution)


def perform_mutation(
    mutation: BaseMutation,
    rng: np.random.RandomState,
    study: "Study",
    distribution: BaseDistribution,
    value: Any,
) -> Any | None:
    """Apply ``mutation`` to one gene through the single-parameter transform
    (reference ``nsgaii/_mutation.py``); ``None`` for non-numerical genes so
    the caller falls back to resampling."""
    if not isinstance(distribution, _NUMERICAL_DISTRIBUTIONS):
        return None
    transform = SearchSpaceTransform({"": distribution}, transform_0_1=False)
    trans_value = transform.transform({"": value})
    mutated = mutation.mutation(float(trans_value[0]), rng, study, transform.bounds[0])
    mutated = np.clip(mutated, transform.bounds[0, 0], transform.bounds[0, 1])
    return transform.untransform(np.array([mutated]))[""]
