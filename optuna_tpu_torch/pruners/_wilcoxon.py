"""Wilcoxon signed-rank pruner (reference ``optuna/pruners/_wilcoxon.py:27,156``).

For objectives that average over a shared instance set (steps = instance
ids): compares the running trial's per-instance values against the best
trial's on the same instances with a one-sided Wilcoxon signed-rank test,
pruning when the trial is significantly worse.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)


class WilcoxonPruner(BasePruner):
    def __init__(self, p_threshold: float = 0.1, n_startup_steps: int = 2) -> None:
        if p_threshold < 0 or p_threshold > 1:
            raise ValueError(f"p_threshold must be in [0, 1], but got {p_threshold}.")
        if n_startup_steps < 0:
            raise ValueError(f"n_startup_steps must be nonnegative, but got {n_startup_steps}.")
        self._p_threshold = p_threshold
        self._n_startup_steps = n_startup_steps

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        if len(trial.intermediate_values) == 0:
            return False
        steps, step_values = np.array(
            sorted(trial.intermediate_values.items()), dtype=float
        ).T
        if np.any(~np.isfinite(step_values)):
            _logger.warning(
                f"Trial {trial.number} has non-finite intermediate values; "
                "WilcoxonPruner ignores those steps."
            )
            finite = np.isfinite(step_values)
            steps, step_values = steps[finite], step_values[finite]
        if len(steps) <= self._n_startup_steps:
            return False

        try:
            best_trial = study.best_trial
        except ValueError:
            return False
        if len(best_trial.intermediate_values) == 0:
            return False
        best_steps, best_values = np.array(
            sorted(best_trial.intermediate_values.items()), dtype=float
        ).T

        _, idx1, idx2 = np.intersect1d(steps, best_steps, return_indices=True)
        if len(idx1) < max(2, self._n_startup_steps):
            return False
        diff = step_values[idx1] - best_values[idx2]
        if study.direction == StudyDirection.MAXIMIZE:
            diff = -diff
        # Never prune a trial whose running average currently beats the best
        # trial's on the shared instances (reference average_is_best guard).
        if float(np.mean(diff)) <= 0.0:
            return False
        # One-sided test: H1 = this trial is worse (diff > 0 median).
        from scipy.stats import wilcoxon

        nonzero = diff[diff != 0]
        if len(nonzero) == 0:
            return False
        p = wilcoxon(nonzero, alternative="greater", zero_method="wilcox").pvalue
        return bool(p < self._p_threshold)
