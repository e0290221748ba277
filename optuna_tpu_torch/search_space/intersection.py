"""Intersection search space over finished trials.

Parity target: ``optuna/search_space/intersection.py:14-58``. Incrementally
intersects ``trial.distributions`` over COMPLETE/PRUNED trials, cached by the
highest trial number seen so repeated calls are O(new trials).
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class IntersectionSearchSpace:
    def __init__(self, include_pruned: bool = False) -> None:
        self._cursor: int = -1
        self._search_space: dict[str, BaseDistribution] | None = None
        self._study_id: int | None = None
        self._include_pruned = include_pruned

    def calculate(self, study: "Study") -> dict[str, BaseDistribution]:
        if self._study_id is None:
            self._study_id = study._study_id
        elif self._study_id != study._study_id:
            raise ValueError("`IntersectionSearchSpace` cannot handle multiple studies.")

        states_of_interest = [TrialState.COMPLETE, TrialState.WAITING]
        if self._include_pruned:
            states_of_interest.append(TrialState.PRUNED)

        next_cursor = self._cursor
        for trial in reversed(study._get_trials(deepcopy=False, use_cache=True)):
            if self._cursor > trial.number:
                break
            if not trial.state.is_finished():
                # RUNNING *and* WAITING trials may still finish later with new
                # distributions; keep the cursor behind them so they get
                # intersected on a future pass.
                next_cursor = trial.number
            if trial.state not in states_of_interest:
                continue
            if trial.state == TrialState.WAITING:
                continue
            if self._search_space is None:
                self._search_space = copy.copy(trial.distributions)
                continue
            self._search_space = {
                name: dist
                for name, dist in self._search_space.items()
                if trial.distributions.get(name) == dist
            }
        self._cursor = next_cursor
        search_space = self._search_space or {}
        return dict(sorted(search_space.items(), key=lambda x: x[0]))


def intersection_search_space(
    trials: list[FrozenTrial], include_pruned: bool = False
) -> dict[str, BaseDistribution]:
    """Stateless variant over an explicit trial list
    (reference ``search_space/intersection.py:109``)."""
    states = (
        (TrialState.COMPLETE, TrialState.PRUNED)
        if include_pruned
        else (TrialState.COMPLETE,)
    )
    search_space: dict[str, BaseDistribution] | None = None
    for trial in trials:
        if trial.state not in states:
            continue
        if search_space is None:
            search_space = copy.copy(trial.distributions)
            continue
        search_space = {
            name: dist
            for name, dist in search_space.items()
            if trial.distributions.get(name) == dist
        }
    return dict(sorted((search_space or {}).items(), key=lambda x: x[0]))
