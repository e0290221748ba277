"""Terminator core + optimize-loop callback (reference ``terminator/terminator.py:33,128``,
``terminator/callback.py:85``)."""

from __future__ import annotations

from typing import TYPE_CHECKING

from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.terminator._evaluators import (
    BaseErrorEvaluator,
    BaseImprovementEvaluator,
    BestValueStagnationEvaluator,
    CrossValidationErrorEvaluator,
    MedianErrorEvaluator,
    RegretBoundEvaluator,
    StaticErrorEvaluator,
)
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)


class BaseTerminator:
    """Terminator protocol (reference ``terminator/terminator.py:25``):
    ``should_terminate(study) -> bool``."""

    def should_terminate(self, study) -> bool:
        raise NotImplementedError


class Terminator(BaseTerminator):
    """should_terminate(study) == improvement_bound < error_estimate."""

    def __init__(
        self,
        improvement_evaluator: BaseImprovementEvaluator | None = None,
        error_evaluator: BaseErrorEvaluator | None = None,
        min_n_trials: int = 20,
    ) -> None:
        if min_n_trials <= 0:
            raise ValueError("`min_n_trials` is expected to be a positive integer.")
        self._improvement_evaluator = improvement_evaluator or RegretBoundEvaluator()
        if error_evaluator is not None:
            self._error_evaluator = error_evaluator
        elif isinstance(self._improvement_evaluator, BestValueStagnationEvaluator):
            self._error_evaluator = StaticErrorEvaluator(0.0)
        else:
            self._error_evaluator = CrossValidationErrorEvaluator()
        self._min_n_trials = min_n_trials

    def should_terminate(self, study: "Study") -> bool:
        trials = study.get_trials(deepcopy=False)
        n_complete = sum(1 for t in trials if t.state == TrialState.COMPLETE)
        if n_complete < self._min_n_trials:
            return False
        improvement = self._improvement_evaluator.evaluate(trials, study.direction)
        error = self._error_evaluator.evaluate(trials, study.direction)
        _logger.debug(f"improvement={improvement}, error={error}")
        return improvement < error


class TerminatorCallback:
    """optimize() callback that stops the study once the terminator fires."""

    def __init__(self, terminator: BaseTerminator | None = None) -> None:
        self._terminator = terminator or Terminator(
            improvement_evaluator=RegretBoundEvaluator(),
            error_evaluator=MedianErrorEvaluator(),
        )

    def __call__(self, study: "Study", trial: FrozenTrial) -> None:
        if self._terminator.should_terminate(study):
            _logger.info("The study has been stopped by the terminator.")
            study.stop()
