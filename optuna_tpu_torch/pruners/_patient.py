"""Patience-wrapped pruner (reference ``optuna/pruners/_patient.py:17``)."""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class PatientPruner(BasePruner):
    """Defer a wrapped pruner until the trial has gone ``patience`` steps
    without improving by more than ``min_delta``."""

    def __init__(
        self,
        wrapped_pruner: BasePruner | None,
        patience: int,
        min_delta: float = 0.0,
    ) -> None:
        if patience < 0:
            raise ValueError(f"patience cannot be negative but got {patience}.")
        if min_delta < 0:
            raise ValueError(f"min_delta cannot be negative but got {min_delta}.")
        self._wrapped_pruner = wrapped_pruner
        self._patience = patience
        self._min_delta = min_delta

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        step = trial.last_step
        if step is None:
            return False
        intermediates = trial.intermediate_values
        steps = np.asarray(sorted(intermediates.keys()))
        if len(steps) <= self._patience + 1:
            return False
        values = np.asarray([intermediates[int(s)] for s in steps], dtype=float)

        # Engage only when the patience window is strictly WORSE than the best
        # before it by more than min_delta — a plateau at the best value is
        # NOT a reason to prune (reference ``_patient.py:91-107``).
        maximize = study.direction == StudyDirection.MAXIMIZE
        before = values[: -self._patience - 1]
        recent = values[-self._patience - 1 :]
        if maximize:
            degraded = np.nanmax(before) - self._min_delta > np.nanmax(recent)
        else:
            degraded = np.nanmin(before) + self._min_delta < np.nanmin(recent)
        if not degraded:
            return False
        if self._wrapped_pruner is None:
            return True
        return self._wrapped_pruner.prune(study, trial)
