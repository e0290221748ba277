"""Drop-in module path alias (reference ``optuna/terminator/erroreval.py``)."""

from optuna_tpu_torch.terminator._evaluators import (
    BaseErrorEvaluator,
    CrossValidationErrorEvaluator,
    StaticErrorEvaluator,
    report_cross_validation_scores,
)

__all__ = [
    "BaseErrorEvaluator",
    "CrossValidationErrorEvaluator",
    "StaticErrorEvaluator",
    "report_cross_validation_scores",
]
