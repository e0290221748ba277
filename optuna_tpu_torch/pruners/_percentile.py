"""Percentile pruner (feature parity: ``optuna/pruners/_percentile.py``).

Prunes when the trial's best intermediate value so far falls on the wrong
side of the chosen percentile of completed trials' values at the same step.

Internally everything is folded to *minimize* orientation: values are
negated when the study maximizes, so the percentile cut and the comparison
are written exactly once.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Iterable

import numpy as np

from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def _is_first_in_interval_step(
    step: int, intermediate_steps: Iterable[int], n_warmup_steps: int, interval_steps: int
) -> bool:
    """True iff ``step`` is the trial's first report at or past the most
    recent pruning checkpoint (checkpoints sit every ``interval_steps``
    starting from ``n_warmup_steps``)."""
    checkpoint = n_warmup_steps + (step - n_warmup_steps) // interval_steps * interval_steps
    assert checkpoint >= 0
    previous_reports = (s for s in intermediate_steps if s != step)
    return max(previous_reports, default=-1) < checkpoint


class PercentilePruner(BasePruner):
    def __init__(
        self,
        percentile: float,
        n_startup_trials: int = 5,
        n_warmup_steps: int = 0,
        interval_steps: int = 1,
        *,
        n_min_trials: int = 1,
    ) -> None:
        constraints = [
            (0.0 <= percentile <= 100.0, f"Percentile must be in [0, 100] but got {percentile}."),
            (n_startup_trials >= 0, f"n_startup_trials cannot be negative: {n_startup_trials}."),
            (n_warmup_steps >= 0, f"n_warmup_steps cannot be negative: {n_warmup_steps}."),
            (interval_steps >= 1, f"interval_steps must be >= 1 but got {interval_steps}."),
            (n_min_trials >= 1, f"n_min_trials must be >= 1 but got {n_min_trials}."),
        ]
        for ok, msg in constraints:
            if not ok:
                raise ValueError(msg)
        self._percentile = percentile
        self._n_startup_trials = n_startup_trials
        self._n_warmup_steps = n_warmup_steps
        self._interval_steps = interval_steps
        self._n_min_trials = n_min_trials

    def _percentile_cut(
        self, peers: list[FrozenTrial], step: int, sign: float
    ) -> float:
        """The percentile of peer values at ``step``, in minimize
        orientation; NaN when fewer than ``n_min_trials`` peers reported.

        Negation already flips the order statistics — P_q(-x) = -P_(100-q)(x)
        — so the same quantile index works for both directions."""
        at_step = np.asarray(
            [sign * t.intermediate_values[step] for t in peers if step in t.intermediate_values],
            dtype=float,
        )
        at_step = at_step[~np.isnan(at_step)]
        if at_step.size < self._n_min_trials:
            return math.nan
        return float(np.percentile(at_step, self._percentile))

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        step = trial.last_step
        if step is None or step < self._n_warmup_steps:
            return False
        if not _is_first_in_interval_step(
            step, trial.intermediate_values.keys(), self._n_warmup_steps, self._interval_steps
        ):
            return False
        peers = study._get_trials(deepcopy=False, states=(TrialState.COMPLETE,), use_cache=True)
        if len(peers) < self._n_startup_trials:
            return False
        if not peers:
            raise ValueError("No trials have been completed.")

        sign = -1.0 if study.direction == StudyDirection.MAXIMIZE else 1.0
        own = sign * np.asarray(list(trial.intermediate_values.values()), dtype=float)
        best_so_far = float(np.nanmin(own))
        if math.isnan(best_so_far):
            return True  # nothing but NaNs reported: hopeless, cut it
        cut = self._percentile_cut(peers, step, sign)
        if math.isnan(cut):
            return False
        return best_so_far > cut
