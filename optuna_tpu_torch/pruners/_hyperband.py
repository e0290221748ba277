"""Hyperband pruner: S parallel SHA brackets with budget-proportional draw.

Parity target: ``optuna/pruners/_hyperband.py:21`` — each trial is hashed
into a bracket by ``crc32(study_name + str(number)) % total_budget``
(``:242-264``); each bracket runs its own SuccessiveHalvingPruner with an
increasing early-stopping rate; samplers see a bracket-restricted view of the
study via ``_BracketStudy`` (hooked through ``pruners._filter_study``).
"""

from __future__ import annotations

import copy
import math
import zlib
from typing import TYPE_CHECKING, Container

from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.pruners._successive_halving import SuccessiveHalvingPruner
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)
_BRACKET_KEY = "hyperband:bracket_id"


class HyperbandPruner(BasePruner):
    def __init__(
        self,
        min_resource: int = 1,
        max_resource: int | str = "auto",
        reduction_factor: int = 3,
        bootstrap_count: int = 0,
    ) -> None:
        self._min_resource = min_resource
        self._max_resource = max_resource
        self._reduction_factor = reduction_factor
        self._bootstrap_count = bootstrap_count
        self._pruners: list[SuccessiveHalvingPruner] = []
        self._total_trial_allocation_budget = 0
        self._trial_allocation_budgets: list[int] = []

        if isinstance(max_resource, str) and max_resource != "auto":
            raise ValueError(f"The value of `max_resource` is {max_resource}, but must be 'auto' or int.")

    @property
    def _n_brackets(self) -> int:
        return len(self._pruners)

    def _try_initialization(self, study: "Study") -> None:
        if self._pruners:
            return
        if self._max_resource == "auto":
            trials = study._get_trials(deepcopy=False, use_cache=True)
            n_steps = [
                t.last_step
                for t in trials
                if t.state == TrialState.COMPLETE and t.last_step is not None
            ]
            if not n_steps:
                return
            self._max_resource = max(n_steps) + 1
        assert isinstance(self._max_resource, int)

        n_brackets = (
            int(
                math.log(self._max_resource / self._min_resource)
                / math.log(self._reduction_factor)
            )
            + 1
        )
        _logger.debug(f"Hyperband has {n_brackets} brackets.")
        for bracket_id in range(n_brackets):
            # Budget allocation proportional to (s_max+1)/(s+1) as in the paper.
            budget = (n_brackets - bracket_id) * (self._reduction_factor**bracket_id)
            self._trial_allocation_budgets.append(budget)
            self._total_trial_allocation_budget += budget
            self._pruners.append(
                SuccessiveHalvingPruner(
                    min_resource=self._min_resource,
                    reduction_factor=self._reduction_factor,
                    min_early_stopping_rate=bracket_id,
                    bootstrap_count=self._bootstrap_count,
                )
            )

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        self._try_initialization(study)
        if not self._pruners:
            return False
        bracket_id = self._get_bracket_id(study, trial)
        _logger.debug(f"{bracket_id}th bracket is selected.")
        bracket_study = self._create_bracket_study(study, trial)
        return self._pruners[bracket_id].prune(bracket_study, trial)

    def _get_bracket_id(self, study: "Study", trial: FrozenTrial) -> int:
        """Deterministic bracket: crc32 hash modulo total budget, mapped onto
        the cumulative allocation (reference ``_hyperband.py:242-264``)."""
        if not self._pruners:
            return 0
        s = f"{study.study_name}_{trial.number}".encode()
        n = zlib.crc32(s) % self._total_trial_allocation_budget
        for bracket_id, budget in enumerate(self._trial_allocation_budgets):
            n -= budget
            if n < 0:
                return bracket_id
        raise AssertionError

    def _create_bracket_study(self, study: "Study", trial: FrozenTrial) -> "Study":
        self._try_initialization(study)
        if not self._pruners:
            return study
        bracket_id = self._get_bracket_id(study, trial)
        return _BracketStudy(study, self, bracket_id)


class _BracketStudy:
    """Bracket-restricted proxy: trial listings only show same-bracket trials
    so SHA rung statistics and samplers stay inside the bracket
    (reference ``_hyperband.py:266-295``)."""

    def __init__(self, study: "Study", pruner: HyperbandPruner, bracket_id: int) -> None:
        self._study = study
        self._pruner = pruner
        self._bracket_id = bracket_id

    def _in_bracket(self, trial: FrozenTrial) -> bool:
        return self._pruner._get_bracket_id(self._study, trial) == self._bracket_id

    def get_trials(
        self, deepcopy: bool = True, states: Container[TrialState] | None = None
    ) -> list[FrozenTrial]:
        return [
            t
            for t in self._study.get_trials(deepcopy=deepcopy, states=states)
            if self._in_bracket(t)
        ]

    def _get_trials(
        self,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
        use_cache: bool = False,
    ) -> list[FrozenTrial]:
        return [
            t
            for t in self._study._get_trials(deepcopy=deepcopy, states=states, use_cache=use_cache)
            if self._in_bracket(t)
        ]

    @property
    def trials(self) -> list[FrozenTrial]:
        return self.get_trials(deepcopy=True)

    def __getattr__(self, name: str):
        return getattr(self._study, name)
