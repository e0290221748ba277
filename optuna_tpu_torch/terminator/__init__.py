"""Automatic termination: stop when expected improvement < evaluation noise.

Parity target: ``optuna/terminator/`` — ``Terminator.should_terminate``
(``terminator.py:33,128``), improvement evaluators (GP-UCB regret bound
``improvement/evaluator.py:97``, best-value stagnation ``:196``, EMMR
``emmr.py:43``), error evaluators (cross-validation ``erroreval.py``, static,
median) and the optimize-loop ``TerminatorCallback``.
"""

from optuna_tpu_torch.terminator._evaluators import (
    BaseErrorEvaluator,
    BaseImprovementEvaluator,
    BestValueStagnationEvaluator,
    CrossValidationErrorEvaluator,
    EMMREvaluator,
    MedianErrorEvaluator,
    RegretBoundEvaluator,
    StaticErrorEvaluator,
    report_cross_validation_scores,
)
from optuna_tpu_torch.terminator._terminator import BaseTerminator, Terminator, TerminatorCallback

__all__ = [
    "BaseTerminator",
    "BaseErrorEvaluator",
    "BaseImprovementEvaluator",
    "BestValueStagnationEvaluator",
    "CrossValidationErrorEvaluator",
    "EMMREvaluator",
    "MedianErrorEvaluator",
    "RegretBoundEvaluator",
    "StaticErrorEvaluator",
    "Terminator",
    "TerminatorCallback",
    "report_cross_validation_scores",
]
