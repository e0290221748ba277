"""Offline trial with fixed params for debugging objectives (port of
``optuna_tpu/trial/_fixed.py``; reference ``optuna/trial/_fixed.py:16``)."""

from __future__ import annotations

import datetime
from typing import Any, Sequence

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalChoiceType,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)


class FixedTrial:
    """Objective-compatible trial that returns pre-set parameter values.

    ``objective(FixedTrial({"x": 1.0}))`` evaluates the objective at a fixed
    point without any study or storage.
    """

    def __init__(self, params: dict[str, Any], number: int = 0) -> None:
        self._params = params
        self._suggested_params: dict[str, Any] = {}
        self._distributions: dict[str, BaseDistribution] = {}
        self._user_attrs: dict[str, Any] = {}
        self._system_attrs: dict[str, Any] = {}
        self._datetime_start = datetime.datetime.now()
        self._number = number

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

    # Deprecated aliases (pre-v3 reference API) — kept on every trial type.

    def suggest_uniform(self, name, low, high):
        import warnings

        warnings.warn(
            "suggest_uniform has been deprecated; use suggest_float instead.",
            FutureWarning,
            stacklevel=2,
        )
        return self.suggest_float(name, low, high)

    def suggest_loguniform(self, name, low, high):
        import warnings

        warnings.warn(
            "suggest_loguniform has been deprecated; use suggest_float(..., log=True).",
            FutureWarning,
            stacklevel=2,
        )
        return self.suggest_float(name, low, high, log=True)

    def suggest_discrete_uniform(self, name, low, high, q):
        import warnings

        warnings.warn(
            "suggest_discrete_uniform has been deprecated; use suggest_float(..., step=q).",
            FutureWarning,
            stacklevel=2,
        )
        return self.suggest_float(name, low, high, step=q)

    def _suggest(self, name: str, distribution: BaseDistribution) -> Any:
        if name not in self._params:
            raise ValueError(
                f"The value of the parameter '{name}' is not found. "
                "Please set it at the construction of the FixedTrial object."
            )
        value = self._params[name]
        param_value_in_internal_repr = distribution.to_internal_repr(value)
        if not distribution._contains(param_value_in_internal_repr):
            raise ValueError(
                f"The value {value} of the parameter '{name}' is out of "
                f"the range of the distribution {distribution}."
            )
        self._suggested_params[name] = value
        self._distributions[name] = distribution
        return value

    def report(self, value: float, step: int) -> None:
        pass

    def should_prune(self) -> bool:
        return False

    def set_user_attr(self, key: str, value: Any) -> None:
        self._user_attrs[key] = value

    def set_system_attr(self, key: str, value: Any) -> None:
        self._system_attrs[key] = value

    @property
    def params(self) -> dict[str, Any]:
        return self._suggested_params

    @property
    def distributions(self) -> dict[str, BaseDistribution]:
        return self._distributions

    @property
    def user_attrs(self) -> dict[str, Any]:
        return self._user_attrs

    @property
    def system_attrs(self) -> dict[str, Any]:
        return self._system_attrs

    @property
    def datetime_start(self) -> datetime.datetime | None:
        return self._datetime_start

    @property
    def number(self) -> int:
        return self._number
