"""Immutable trial records — the currency of the whole system.

Parity target: ``optuna/trial/_frozen.py:39`` (``FrozenTrial``), ``:543``
(``create_trial``). Samplers, storages, pruners and plots all consume lists of
these. Kept as a plain mutable-slots class (not a frozen dataclass) because
storage backends construct and patch them on the hot path.
"""

from __future__ import annotations

import datetime
from typing import Any, Sequence

from optuna_tpu_torch.distributions import BaseDistribution, check_distribution_compatibility
from optuna_tpu_torch.trial._state import TrialState


def _check_float(value: Any, *, arg: str = "value") -> float:
    """Coerce to float or raise the storage-layer TypeError message."""
    try:
        return float(value)
    except (TypeError, ValueError):
        raise TypeError(
            f"The `{arg}` argument is of type '{type(value).__name__}' "
            "but supposed to be a float."
        ) from None


class FrozenTrial:
    """A finished (or snapshot of a live) trial.

    ``params`` holds external representations; ``distributions`` maps each
    param name to its distribution. ``values`` is a list (multi-objective
    ready); the single-objective ``value`` property guards against misuse.
    """

    __slots__ = (
        "number",
        "state",
        "params",
        "_distributions",
        "user_attrs",
        "system_attrs",
        "intermediate_values",
        "datetime_start",
        "datetime_complete",
        "_trial_id",
        "_values",
    )

    def __init__(
        self,
        number: int,
        state: TrialState,
        value: float | None,
        datetime_start: datetime.datetime | None,
        datetime_complete: datetime.datetime | None,
        params: dict[str, Any],
        distributions: dict[str, BaseDistribution],
        user_attrs: dict[str, Any],
        system_attrs: dict[str, Any],
        intermediate_values: dict[int, float],
        trial_id: int,
        *,
        values: Sequence[float] | None = None,
    ) -> None:
        if value is not None and values is not None:
            raise ValueError("Specify only one of `value` and `values`.")
        self.number = number
        self.state = state
        self.params = params
        self._distributions = distributions
        self.user_attrs = user_attrs
        self.system_attrs = system_attrs
        self.intermediate_values = intermediate_values
        self.datetime_start = datetime_start
        self.datetime_complete = datetime_complete
        self._trial_id = trial_id
        if value is not None:
            self._values: list[float] | None = [float(value)]
        elif values is not None:
            self._values = [float(v) for v in values]
        else:
            self._values = None

    def _structural_copy(self) -> "FrozenTrial":
        """Fresh FrozenTrial with copied containers but shared scalar leaves.

        Isolation-equivalent to ``copy.deepcopy`` for every mutation the
        runtime performs (field assignment, dict insertion) at a fraction of
        the cost — deepcopy walks 50 distribution dataclasses per read on a
        wide space, which dominated the tell path. Scalar leaf values
        (numbers, strings, datetimes, distributions-by-convention) are
        immutable and shared; attr values that are themselves mutable
        containers (a user's ``user_attrs['hist']`` list, say) are
        deep-copied so in-place mutation of a returned trial can never write
        through to storage internals (ADVICE r3). The reference shares the
        entire object without any copy
        (``optuna/storages/_in_memory.py:362-369``), so this is strictly
        more isolated than the parity target."""

        _scalar = (int, float, complex, bool, str, bytes, type(None), datetime.datetime)

        def _copy_attrs(attrs: dict) -> dict:
            # Scalars are shared; anything else (lists, dicts, ndarrays,
            # tuples that may wrap mutables) is deep-copied.
            if all(isinstance(v, _scalar) for v in attrs.values()):
                return dict(attrs)  # hot path: scalar-only attrs, one shallow copy
            import copy as _copy

            return {
                k: v if isinstance(v, _scalar) else _copy.deepcopy(v)
                for k, v in attrs.items()
            }

        return FrozenTrial(
            number=self.number,
            state=self.state,
            value=None,
            datetime_start=self.datetime_start,
            datetime_complete=self.datetime_complete,
            params=dict(self.params),
            distributions=dict(self._distributions),
            user_attrs=_copy_attrs(self.user_attrs),
            system_attrs=_copy_attrs(self.system_attrs),
            intermediate_values=dict(self.intermediate_values),
            trial_id=self._trial_id,
            values=list(self._values) if self._values is not None else None,
        )

    # ------------------------------------------------------------------ values

    @property
    def value(self) -> float | None:  # type: ignore[override]
        if self._values is None:
            return None
        if len(self._values) > 1:
            raise RuntimeError("This attribute is not available during multi-objective optimization.")
        return self._values[0]

    @value.setter
    def value(self, v: float | None) -> None:
        self._values = None if v is None else [float(v)]

    @property
    def values(self) -> list[float] | None:
        return self._values

    @values.setter
    def values(self, v: Sequence[float] | None) -> None:
        self._values = None if v is None else [float(x) for x in v]

    @property
    def distributions(self) -> dict[str, BaseDistribution]:
        return self._distributions

    @distributions.setter
    def distributions(self, value: dict[str, BaseDistribution]) -> None:
        self._distributions = value

    # ------------------------------------------------------------------- misc

    @property
    def last_step(self) -> int | None:
        if len(self.intermediate_values) == 0:
            return None
        return max(self.intermediate_values.keys())

    @property
    def duration(self) -> datetime.timedelta | None:
        if self.datetime_start is not None and self.datetime_complete is not None:
            return self.datetime_complete - self.datetime_start
        return None

    @property
    def constraints(self) -> dict[str, float]:
        """Named constraint values; feasible iff every value <= 0
        (reference ``_frozen.py:485``)."""
        from optuna_tpu_torch.study._constrained_optimization import (
            _get_constraints_from_system_attrs,
        )

        return _get_constraints_from_system_attrs(self.system_attrs)

    def set_constraint(self, key: str, value: float) -> None:
        """Attach a named constraint value (reference ``_frozen.py:496``)."""
        from optuna_tpu_torch.study._constrained_optimization import _CONSTRAINTS_KEY

        self.system_attrs[f"{_CONSTRAINTS_KEY}:{key}"] = _check_float(value)

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value

    def set_system_attr(self, key: str, value: Any) -> None:
        self.system_attrs[key] = value

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, FrozenTrial):
            return NotImplemented
        return self._asdict() == other._asdict()

    def __lt__(self, other: Any) -> bool:
        if not isinstance(other, FrozenTrial):
            return NotImplemented
        return self.number < other.number

    def __le__(self, other: Any) -> bool:
        if not isinstance(other, FrozenTrial):
            return NotImplemented
        return self.number <= other.number

    __hash__ = None  # type: ignore[assignment]  # mutable record; identity not stable

    def _asdict(self) -> dict[str, Any]:
        return {
            "number": self.number,
            "values": self._values,
            "datetime_start": self.datetime_start,
            "datetime_complete": self.datetime_complete,
            "params": self.params,
            "user_attrs": self.user_attrs,
            "system_attrs": self.system_attrs,
            "state": self.state,
            "intermediate_values": self.intermediate_values,
            "distributions": self._distributions,
            "trial_id": self._trial_id,
        }

    def __repr__(self) -> str:
        return (
            f"FrozenTrial(number={self.number}, state={self.state!r}, "
            f"values={self._values}, params={self.params})"
        )

    def report(self, value: float, step: int) -> None:
        """No-op mirror of ``Trial.report`` so objectives can be dry-run
        against frozen trials (reference ``_frozen.py:220``)."""
        # Frozen trials are records; reporting is meaningful only on live trials.

    def should_prune(self) -> bool:
        return False

    # Suggest API on frozen trials replays recorded params (used by
    # ``Study.add_trial`` round-trips and retried trials).
    def _suggest(self, name: str, distribution: BaseDistribution) -> Any:
        if name not in self.params:
            raise ValueError(f"The parameter {name!r} is not found in this trial.")
        value = self.params[name]
        if not distribution._contains(distribution.to_internal_repr(value)):
            raise ValueError(
                f"The value {value!r} of parameter {name!r} is out of the distribution {distribution}."
            )
        return value

    def suggest_float(
        self, name: str, low: float, high: float, *, step: float | None = None, log: bool = False
    ) -> float:
        from optuna_tpu_torch.distributions import FloatDistribution

        return self._suggest(name, FloatDistribution(low, high, log=log, step=step))

    def suggest_int(
        self, name: str, low: int, high: int, *, step: int = 1, log: bool = False
    ) -> int:
        from optuna_tpu_torch.distributions import IntDistribution

        return self._suggest(name, IntDistribution(low, high, log=log, step=step))

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        from optuna_tpu_torch.distributions import CategoricalDistribution

        return self._suggest(name, CategoricalDistribution(choices))

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

    def _validate(self) -> None:
        """Invariant checks before a frozen trial enters a storage
        (reference ``_frozen.py:312``)."""
        if self.datetime_start is None and self.state != TrialState.WAITING:
            raise ValueError("`datetime_start` is supposed to be set.")
        if self.state.is_finished() and self.datetime_complete is None:
            raise ValueError("`datetime_complete` is supposed to be set for a finished trial.")
        if not self.state.is_finished() and self.datetime_complete is not None:
            raise ValueError("`datetime_complete` is supposed to be None for a running/waiting trial.")
        if self.state == TrialState.COMPLETE and self._values is None:
            raise ValueError("`value` is supposed to be set for a complete trial.")
        if set(self.params.keys()) != set(self._distributions.keys()):
            raise ValueError(
                "Inconsistent parameters and distributions: "
                f"params={set(self.params)}, distributions={set(self._distributions)}."
            )
        for param_name, param_value in self.params.items():
            distribution = self._distributions[param_name]
            param_value_internal = distribution.to_internal_repr(param_value)
            if not distribution._contains(param_value_internal):
                raise ValueError(
                    f"The value {param_value!r} of parameter {param_name!r} isn't contained "
                    f"in the distribution {distribution}."
                )


def create_trial(
    *,
    state: TrialState | None = None,
    value: float | None = None,
    values: Sequence[float] | None = None,
    params: dict[str, Any] | None = None,
    distributions: dict[str, BaseDistribution] | None = None,
    user_attrs: dict[str, Any] | None = None,
    system_attrs: dict[str, Any] | None = None,
    intermediate_values: dict[int, float] | None = None,
) -> FrozenTrial:
    """Factory for user-constructed trials fed to ``study.add_trial``
    (reference ``optuna/trial/_frozen.py:543``)."""
    params = params or {}
    distributions = distributions or {}
    user_attrs = user_attrs or {}
    system_attrs = system_attrs or {}
    intermediate_values = intermediate_values or {}
    state = state if state is not None else TrialState.COMPLETE

    datetime_start = datetime.datetime.now()
    datetime_complete = datetime_start if state.is_finished() else None

    trial = FrozenTrial(
        number=-1,
        trial_id=-1,
        state=state,
        value=None if values is not None else value,
        values=values,
        datetime_start=datetime_start,
        datetime_complete=datetime_complete,
        params=params,
        distributions=distributions,
        user_attrs=user_attrs,
        system_attrs=system_attrs,
        intermediate_values=intermediate_values,
    )
    trial._validate()
    return trial
