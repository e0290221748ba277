"""Decorator sampler pinning a subset of params (port of
``optuna_tpu/samplers/_partial_fixed.py``; reference
``optuna/samplers/_partial_fixed.py:21``). It runs the wrapped sampler
as it is, so over ``GPSampler()`` the free params are sampled on the card."""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Any, Sequence

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class PartialFixedSampler(BaseSampler):
    def __init__(self, fixed_params: dict[str, Any], base_sampler: BaseSampler) -> None:
        self._fixed_params = fixed_params
        self._base_sampler = base_sampler

    def reseed_rng(self) -> None:
        self._base_sampler.reseed_rng()

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        search_space = self._base_sampler.infer_relative_search_space(study, trial)
        for param_name in self._fixed_params:
            search_space.pop(param_name, None)
        return search_space

    def sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        return self._base_sampler.sample_relative(study, trial, search_space)

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        if param_name not in self._fixed_params:
            return self._base_sampler.sample_independent(
                study, trial, param_name, param_distribution
            )
        param_value = self._fixed_params[param_name]
        param_value_in_internal_repr = param_distribution.to_internal_repr(param_value)
        if not param_distribution._contains(param_value_in_internal_repr):
            warnings.warn(
                f"Fixed parameter '{param_name}' with value {param_value} is out of range "
                f"for distribution {param_distribution}."
            )
        return param_value

    def before_trial(self, study: "Study", trial: FrozenTrial) -> None:
        self._base_sampler.before_trial(study, trial)

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        self._base_sampler.after_trial(study, trial, state, values)
