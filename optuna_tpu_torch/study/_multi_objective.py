"""Pareto-front and domination helpers.

Parity target: ``optuna/study/_multi_objective.py`` (``_get_pareto_front_trials:43``).
Host NumPy only: the non-domination ranking and its
device branch (``optuna_tpu/study/_multi_objective.py:115``) come with the
multi-objective slice.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def _normalize_values(
    objective_values: np.ndarray, directions: Sequence[StudyDirection]
) -> np.ndarray:
    """Flip MAXIMIZE columns so that smaller is always better."""
    values = np.asarray(objective_values, dtype=np.float64).copy()
    for i, d in enumerate(directions):
        if d == StudyDirection.MAXIMIZE:
            values[:, i] *= -1
    return values


def _is_pareto_front(values: np.ndarray, assume_unique_lexsorted: bool = False) -> np.ndarray:
    """Boolean mask of non-dominated rows (minimization convention)
    (reference ``_multi_objective.py:171``)."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=bool)
    on_front = np.ones(n, dtype=bool)
    leq = np.all(values[:, None, :] <= values[None, :, :], axis=2)
    lt = np.any(values[:, None, :] < values[None, :, :], axis=2)
    dom = leq & lt
    on_front = ~np.any(dom, axis=0)
    return on_front


def _get_pareto_front_trials_by_trials(
    trials: Sequence[FrozenTrial],
    directions: Sequence[StudyDirection],
    consider_constraint: bool = False,
) -> list[FrozenTrial]:
    from optuna_tpu_torch.study._constrained_optimization import _is_feasible

    complete = [t for t in trials if t.state == TrialState.COMPLETE]
    if consider_constraint:
        complete = [t for t in complete if _is_feasible(t.system_attrs)]
    if len(complete) == 0:
        return []
    values = _normalize_values(
        np.asarray([t.values for t in complete], dtype=np.float64), directions
    )
    nan_rows = np.any(np.isnan(values), axis=1)
    mask = _is_pareto_front(np.where(nan_rows[:, None], np.inf, values))
    mask &= ~nan_rows
    return [t for t, m in zip(complete, mask) if m]


def _get_pareto_front_trials(
    study: "Study", consider_constraint: bool = False
) -> list[FrozenTrial]:
    return _get_pareto_front_trials_by_trials(
        study.trials, study.directions, consider_constraint
    )
