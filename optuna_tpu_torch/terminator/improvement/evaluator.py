"""Drop-in module path alias (reference ``optuna/terminator/improvement/evaluator.py``)."""

from optuna_tpu_torch.terminator._evaluators import (
    BaseImprovementEvaluator,
    BestValueStagnationEvaluator,
    RegretBoundEvaluator,
)

__all__ = [
    "BaseImprovementEvaluator",
    "BestValueStagnationEvaluator",
    "RegretBoundEvaluator",
]
