"""Asynchronous Successive Halving (ASHA) pruner.

Parity target: ``optuna/pruners/_successive_halving.py:15,167`` — rungs are
recorded per trial as ``completed_rung_{i}`` system attrs; a trial is
promoted past rung i only if its value is in the top 1/reduction_factor of
that rung's recorded values (asynchronous variant — no waiting for cohorts).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


_COMPLETED_RUNG_KEY_PREFIX = "completed_rung_"


def _completed_rung_key(rung: int) -> str:
    return f"{_COMPLETED_RUNG_KEY_PREFIX}{rung}"


def _get_current_rung(trial: FrozenTrial) -> int:
    rung = 0
    while _completed_rung_key(rung) in trial.system_attrs:
        rung += 1
    return rung


def _is_trial_promotable_to_next_rung(
    value: float,
    rung_values: list[float],
    reduction_factor: int,
    direction: StudyDirection,
) -> bool:
    n = len(rung_values)
    quantile_n = n // reduction_factor
    values = sorted(rung_values, reverse=(direction == StudyDirection.MAXIMIZE))
    if quantile_n == 0:
        # Too few competitors for a proper quantile: promote only the current
        # best (reference ``_successive_halving.py:214`` — early bad trials
        # must still be cut, otherwise ASHA degenerates to full budgets).
        if n == 0:
            return True
        if direction == StudyDirection.MAXIMIZE:
            return value >= values[0]
        return value <= values[0]
    cutoff = values[quantile_n - 1]
    if direction == StudyDirection.MAXIMIZE:
        return value >= cutoff
    return value <= cutoff


class SuccessiveHalvingPruner(BasePruner):
    def __init__(
        self,
        min_resource: int | str = "auto",
        reduction_factor: int = 4,
        min_early_stopping_rate: int = 0,
        bootstrap_count: int = 0,
    ) -> None:
        if isinstance(min_resource, str) and min_resource != "auto":
            raise ValueError(f"The value of `min_resource` is {min_resource}, but must be 'auto' or int >= 1.")
        if isinstance(min_resource, int) and min_resource < 1:
            raise ValueError(f"The value of `min_resource` is {min_resource}, but must be >= 1.")
        if reduction_factor < 2:
            raise ValueError(f"The value of `reduction_factor` is {reduction_factor}, but must be >= 2.")
        if min_early_stopping_rate < 0:
            raise ValueError(
                f"The value of `min_early_stopping_rate` is {min_early_stopping_rate}, but must be >= 0."
            )
        if bootstrap_count < 0:
            raise ValueError(f"The value of `bootstrap_count` is {bootstrap_count}, but must be >= 0.")
        if bootstrap_count > 0 and min_resource == "auto":
            raise ValueError(
                "bootstrap_count > 0 is incompatible with min_resource='auto'."
            )
        self._min_resource: int | None = min_resource if isinstance(min_resource, int) else None
        self._reduction_factor = reduction_factor
        self._min_early_stopping_rate = min_early_stopping_rate
        self._bootstrap_count = bootstrap_count

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        step = trial.last_step
        if step is None:
            return False
        rung = _get_current_rung(trial)
        value = trial.intermediate_values[step]
        all_trials: list[FrozenTrial] | None = None

        while True:
            if self._min_resource is None:
                self._min_resource = _estimate_min_resource(
                    study._get_trials(deepcopy=False, use_cache=True)
                )
                if self._min_resource is None:
                    return False
            assert self._min_resource is not None
            rung_promotion_step = self._min_resource * (
                self._reduction_factor ** (self._min_early_stopping_rate + rung)
            )
            if step < rung_promotion_step:
                return False
            if math.isnan(value):
                return True
            if all_trials is None:
                all_trials = study._get_trials(deepcopy=False, use_cache=True)

            key = _completed_rung_key(rung)
            study._storage.set_trial_system_attr(trial._trial_id, key, value)

            competing = [
                t.system_attrs[key]
                for t in all_trials
                if key in t.system_attrs and t.number != trial.number
            ]
            if len(competing) + 1 <= self._bootstrap_count:
                return True  # wait until a full bootstrap cohort has recorded
            if not _is_trial_promotable_to_next_rung(
                value, competing, self._reduction_factor, study.direction
            ):
                return True
            rung += 1


def _estimate_min_resource(trials: list[FrozenTrial]) -> int | None:
    """'auto': ~1% of the deepest-seen trial's steps, so rung 0 engages early
    (reference heuristic, ``_successive_halving.py:238``)."""
    n_steps = [
        t.last_step for t in trials if t.state == TrialState.COMPLETE and t.last_step is not None
    ]
    if not n_steps:
        return None
    return max(max(n_steps) // 100, 1)
