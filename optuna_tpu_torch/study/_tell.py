"""The tell path: validate, promote pruned values, notify sampler, commit.

Parity target: ``optuna/study/_tell.py`` (``_tell_with_warning:80``,
``_check_values_are_feasible:60``).
"""

from __future__ import annotations

import copy
import math
import warnings
from typing import TYPE_CHECKING, Sequence

from optuna_tpu_torch import logging as logging_module
from optuna_tpu_torch import pruners as pruners_module
from optuna_tpu_torch.exceptions import UpdateFinishedTrialError
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState
from optuna_tpu_torch.trial._trial import Trial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = logging_module.get_logger(__name__)


def _check_values_are_feasible(study: "Study", values: Sequence[float]) -> str | None:
    for v in values:
        if v is None:
            return "The value None could not be cast to float."
        try:
            is_nan = math.isnan(v)
        except (TypeError, OverflowError):
            # A value math.isnan cannot take — non-numeric (TypeError) or an
            # int too large for float (OverflowError) — must surface as the
            # same infeasibility message family, not escape the guard.
            return f"The value {v!r} could not be cast to float."
        if is_nan:
            return f"The value {v} is not acceptable."
    if len(study.directions) != len(values):
        return (
            f"The number of the values {len(values)} did not match the number of the "
            f"objectives {len(study.directions)}."
        )
    return None


def _check_and_convert_to_values(
    n_objectives: int, original_value: float | Sequence[float] | None
) -> tuple[list[float] | None, str | None]:
    if isinstance(original_value, Sequence):
        if n_objectives != len(original_value):
            return (
                None,
                f"The number of the values {len(original_value)} did not match the "
                f"number of the objectives {n_objectives}.",
            )
        _original_values: Sequence[float | None] = list(original_value)
    else:
        _original_values = [original_value]

    values = []
    for v in _original_values:
        checked, failure_message = _try_float(v)
        if failure_message is not None:
            return None, failure_message
        values.append(checked)
    return values, None  # type: ignore[return-value]


def _try_float(value: float | None) -> tuple[float | None, str | None]:
    try:
        if value is None:
            return None, "The value None could not be cast to float."
        value = float(value)
    except (ValueError, TypeError):
        return None, f"The value {value!r} could not be cast to float."
    if math.isnan(value):
        return None, f"The value {value} is not acceptable."
    return value, None


def _tell_with_warning(
    study: "Study",
    trial: Trial | int,
    value_or_values: float | Sequence[float] | None = None,
    state: TrialState | None = None,
    skip_if_finished: bool = False,
    suppress_warning: bool = False,
) -> FrozenTrial:
    """Core of ``study.tell``; returns the (frozen) told trial."""
    if not isinstance(trial, (Trial, int)):
        raise TypeError("Trial must be a trial object or trial number.")
    if state == TrialState.COMPLETE and value_or_values is None:
        raise ValueError(
            "No values were told. Values are required when state is TrialState.COMPLETE."
        )
    if state in (TrialState.PRUNED, TrialState.FAIL) and value_or_values is not None:
        raise ValueError(
            "Values were told. Values cannot be specified when state is "
            "TrialState.PRUNED or TrialState.FAIL."
        )
    if state is not None and state not in (
        TrialState.COMPLETE,
        TrialState.PRUNED,
        TrialState.FAIL,
    ):
        raise ValueError(f"Cannot tell with state {state}.")

    if isinstance(trial, Trial):
        trial_id = trial._trial_id
    else:
        if trial < 0:
            raise ValueError(f"Cannot tell for negative trial number {trial}.")
        try:
            trial_id = study._storage.get_trial_id_from_study_id_trial_number(
                study._study_id, trial
            )
        except KeyError as e:
            raise ValueError(
                f"Cannot tell for trial with number {trial} because it does not exist."
            ) from e

    frozen_trial = study._storage.get_trial(trial_id)
    warning_message = None

    if frozen_trial.state.is_finished() and skip_if_finished:
        _logger.info(
            f"Skipped telling trial {frozen_trial.number} with values "
            f"{value_or_values} and state {state} since trial was already finished. "
            f"Finished trial has values {frozen_trial.values} and state {frozen_trial.state}."
        )
        return frozen_trial._structural_copy()

    if state == TrialState.PRUNED:
        # Register the last intermediate value as the trial value if it exists
        # (reference _tell.py:134-144).
        assert value_or_values is None
        last_step = frozen_trial.last_step
        if last_step is not None:
            last_intermediate = frozen_trial.intermediate_values[last_step]
            if _check_values_are_feasible(study, [last_intermediate]) is None:
                value_or_values = last_intermediate

    values: list[float] | None = None
    if state is None:
        if value_or_values is None:
            state = TrialState.FAIL
            warning_message = (
                "The objective function returned None. State is set to TrialState.FAIL."
            )
        else:
            values, values_conversion_failure_message = _check_and_convert_to_values(
                len(study.directions), value_or_values
            )
            if values_conversion_failure_message is None:
                state = TrialState.COMPLETE
            else:
                state = TrialState.FAIL
                warning_message = values_conversion_failure_message
    elif value_or_values is not None:
        values, values_conversion_failure_message = _check_and_convert_to_values(
            len(study.directions), value_or_values
        )
        if values_conversion_failure_message is not None:
            raise ValueError(values_conversion_failure_message)

    assert state is not None
    if frozen_trial.state.is_finished():
        # Matches the reference: mutating a finished trial surfaces the
        # storage-layer error unless the caller opted into skip_if_finished.
        raise UpdateFinishedTrialError(
            f"Cannot tell trial {frozen_trial.number}: it is already finished "
            f"with state {frozen_trial.state!r}. Pass skip_if_finished=True to ignore."
        )
    if warning_message is not None:
        if not suppress_warning:
            warnings.warn(warning_message)
        study._storage.set_trial_system_attr(trial_id, "fail_reason", warning_message)
    # Sampler post-processing (CMA tell, constraints write) happens with
    # the trial still RUNNING so after_trial may write system attrs.
    filtered_study = pruners_module._filter_study(study, frozen_trial)
    study.sampler.after_trial(filtered_study, frozen_trial, state, values)
    study._storage.set_trial_state_values(trial_id, state=state, values=values)

    # Structural copy: isolates the returned trial from storage internals
    # without deep-walking 50 distribution objects per tell (CMA/50D was
    # spending 60% of its wall time in deepcopy here).
    return study._storage.get_trial(trial_id)._structural_copy()
