"""Live trial handle passed to the user's objective.

Parity target: ``optuna/trial/_trial.py:40-834``: suggest dispatch
(fixed -> single -> relative -> independent, ``_suggest:627``),
``report:419`` / ``should_prune:520``, constraints (``set_constraint``),
user/system attrs. The relative search space is inferred lazily at the first
``suggest_*`` call — that's where a batched sampler (TPE/GP/CMA-ES) runs its
jit-compiled joint suggestion once per trial.
"""

from __future__ import annotations

import copy
import datetime
import math
import warnings
from typing import TYPE_CHECKING, Any, Sequence

from optuna_tpu_torch import pruners as pruners_module
from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalChoiceType,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
    check_distribution_compatibility,
)
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


_SUGGESTED_STATES = (TrialState.COMPLETE, TrialState.PRUNED)
_FIXED_PARAMS_KEY = "fixed_params"


class Trial:
    """A single execution of the objective function."""

    def __init__(self, study: "Study", trial_id: int) -> None:
        self.study = study
        self._trial_id = trial_id
        self.storage = self.study._storage
        self._init_relative_params()

    def _init_relative_params(self) -> None:
        self._cached_frozen_trial = self.storage.get_trial(self._trial_id)
        study = pruners_module._filter_study(self.study, self._cached_frozen_trial)
        self.relative_search_space = self.study.sampler.infer_relative_search_space(
            study, self._cached_frozen_trial
        )
        self.relative_params: dict[str, Any] | None = None
        self._study_for_relative_sampling = study

    def _ensure_relative_params(self) -> dict[str, Any]:
        # Deferred until the first suggest so ``before_trial`` hooks and
        # enqueued fixed params are all visible to the sampler.
        if self.relative_params is None:
            self.relative_params = self.study.sampler.sample_relative(
                self._study_for_relative_sampling,
                self._cached_frozen_trial,
                self.relative_search_space,
            )
        return self.relative_params

    # ---------------------------------------------------------------- suggest

    def suggest_float(
        self,
        name: str,
        low: float,
        high: float,
        *,
        step: float | None = None,
        log: bool = False,
    ) -> float:
        return self._suggest(name, FloatDistribution(low, high, log=log, step=step))

    def suggest_int(
        self, name: str, low: int, high: int, *, step: int = 1, log: bool = False
    ) -> int:
        return int(self._suggest(name, IntDistribution(low, high, log=log, step=step)))

    def suggest_categorical(
        self, name: str, choices: Sequence[CategoricalChoiceType]
    ) -> CategoricalChoiceType:
        return self._suggest(name, CategoricalDistribution(choices=choices))

    # Deprecated aliases kept for drop-in compatibility with pre-v3 reference
    # code (`suggest_uniform`/`suggest_loguniform`/`suggest_discrete_uniform`).

    def suggest_uniform(self, name: str, low: float, high: float) -> float:
        warnings.warn(
            "suggest_uniform has been deprecated; use suggest_float instead.",
            FutureWarning,
            stacklevel=2,
        )
        return self.suggest_float(name, low, high)

    def suggest_loguniform(self, name: str, low: float, high: float) -> float:
        warnings.warn(
            "suggest_loguniform has been deprecated; use suggest_float(..., log=True).",
            FutureWarning,
            stacklevel=2,
        )
        return self.suggest_float(name, low, high, log=True)

    def suggest_discrete_uniform(self, name: str, low: float, high: float, q: float) -> float:
        warnings.warn(
            "suggest_discrete_uniform has been deprecated; use suggest_float(..., step=q).",
            FutureWarning,
            stacklevel=2,
        )
        return self.suggest_float(name, low, high, step=q)

    def _suggest(self, name: str, distribution: BaseDistribution) -> Any:
        storage = self.storage
        trial_id = self._trial_id
        trial = self._cached_frozen_trial

        if name in trial.params:
            # Repeated suggestion for the same name must agree on the distribution.
            check_distribution_compatibility(trial.distributions[name], distribution)
            return trial.params[name]

        if self._is_fixed_param(name, distribution):
            param_value = self._cached_frozen_trial.system_attrs[_FIXED_PARAMS_KEY][name]
        elif distribution.single():
            param_value = distribution.to_external_repr(
                distribution.to_internal_repr(
                    distribution.choices[0]
                    if isinstance(distribution, CategoricalDistribution)
                    else distribution.low
                )
            )
        elif self._is_relative_param(name, distribution):
            param_value = self._ensure_relative_params()[name]
        else:
            study = pruners_module._filter_study(self.study, trial)
            param_value = self.study.sampler.sample_independent(
                study, trial, name, distribution
            )

        param_value_internal = distribution.to_internal_repr(param_value)
        storage.set_trial_param(trial_id, name, param_value_internal, distribution)
        trial._distributions = {**trial._distributions, name: distribution}
        trial.params = {**trial.params, name: distribution.to_external_repr(param_value_internal)}
        return trial.params[name]

    def _is_fixed_param(self, name: str, distribution: BaseDistribution) -> bool:
        fixed = self._cached_frozen_trial.system_attrs.get(_FIXED_PARAMS_KEY)
        if fixed is None or name not in fixed:
            return False
        value = fixed[name]
        value_internal = distribution.to_internal_repr(value)
        contained = distribution._contains(value_internal)
        if not contained:
            warnings.warn(
                f"Fixed parameter '{name}' with value {value!r} is out of range "
                f"for distribution {distribution}."
            )
        return contained

    def _is_relative_param(self, name: str, distribution: BaseDistribution) -> bool:
        if name not in self.relative_search_space:
            return False
        relative_params = self._ensure_relative_params()
        if name not in relative_params:
            return False
        check_distribution_compatibility(self.relative_search_space[name], distribution)
        param_value = relative_params[name]
        return distribution._contains(distribution.to_internal_repr(param_value))

    # ----------------------------------------------------------------- report

    def report(self, value: float, step: int) -> None:
        """Record an intermediate objective value at ``step`` for pruning
        (reference ``_trial.py:419``)."""
        if self.study._is_multi_objective():
            raise NotImplementedError(
                "Trial.report is not supported for multi-objective optimization."
            )
        try:
            value = float(value)
        except (TypeError, ValueError) as e:
            raise TypeError(
                f"The `value` argument is of type '{type(value).__name__}' but supposed to "
                "be a float."
            ) from e
        if step < 0:
            raise ValueError(f"The `step` argument is {step} but cannot be negative.")
        if step in self._cached_frozen_trial.intermediate_values:
            warnings.warn(
                f"The reported value is ignored because this `step` {step} is already reported."
            )
            return
        self.storage.set_trial_intermediate_value(self._trial_id, step, value)
        self._cached_frozen_trial.intermediate_values = {
            **self._cached_frozen_trial.intermediate_values,
            step: value,
        }

    def should_prune(self) -> bool:
        """Ask the study's pruner whether to stop this trial now
        (reference ``_trial.py:520``)."""
        if self.study._is_multi_objective():
            raise NotImplementedError(
                "Trial.should_prune is not supported for multi-objective optimization."
            )
        trial = self.storage.get_trial(self._trial_id)
        return self.study.pruner.prune(self.study, trial)

    # ------------------------------------------------------------------ attrs

    def set_user_attr(self, key: str, value: Any) -> None:
        self.storage.set_trial_user_attr(self._trial_id, key, value)
        self._cached_frozen_trial.user_attrs = {
            **self._cached_frozen_trial.user_attrs,
            key: value,
        }

    @property
    def constraints(self) -> dict[str, float]:
        """Named constraint values; feasible iff every value <= 0
        (reference ``_trial.py:773``)."""
        from optuna_tpu_torch.study._constrained_optimization import (
            _get_constraints_from_system_attrs,
        )

        return _get_constraints_from_system_attrs(
            self.storage.get_trial(self._trial_id).system_attrs
        )

    def set_constraint(self, key: str, value: float) -> None:
        """Attach a named constraint value (reference ``_trial.py:785``).
        Constraint-aware samplers and the Pareto-front plot treat the trial
        as infeasible when any value is positive."""
        from optuna_tpu_torch.study._constrained_optimization import _CONSTRAINTS_KEY
        from optuna_tpu_torch.trial._frozen import _check_float

        self.storage.set_trial_system_attr(
            self._trial_id, f"{_CONSTRAINTS_KEY}:{key}", _check_float(value)
        )

    def set_system_attr(self, key: str, value: Any) -> None:
        self.storage.set_trial_system_attr(self._trial_id, key, value)
        self._cached_frozen_trial.system_attrs = {
            **self._cached_frozen_trial.system_attrs,
            key: value,
        }

    # ------------------------------------------------------------- properties

    @property
    def number(self) -> int:
        return self._cached_frozen_trial.number

    @property
    def params(self) -> dict[str, Any]:
        return copy.deepcopy(self._cached_frozen_trial.params)

    @property
    def distributions(self) -> dict[str, BaseDistribution]:
        return copy.deepcopy(self._cached_frozen_trial.distributions)

    @property
    def user_attrs(self) -> dict[str, Any]:
        return copy.deepcopy(self._cached_frozen_trial.user_attrs)

    @property
    def system_attrs(self) -> dict[str, Any]:
        return copy.deepcopy(self.storage.get_trial(self._trial_id).system_attrs)

    @property
    def datetime_start(self) -> datetime.datetime | None:
        return self._cached_frozen_trial.datetime_start

    @property
    def relative_trials(self) -> list[FrozenTrial]:
        return [
            t
            for t in self.study.get_trials(deepcopy=False)
            if t.state in _SUGGESTED_STATES
        ]
