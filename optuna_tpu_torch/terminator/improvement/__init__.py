"""Drop-in package path alias (reference ``optuna/terminator/improvement/``)."""

from optuna_tpu_torch.terminator._evaluators import (
    BaseImprovementEvaluator,
    BestValueStagnationEvaluator,
    EMMREvaluator,
    RegretBoundEvaluator,
)

__all__ = [
    "BaseImprovementEvaluator",
    "BestValueStagnationEvaluator",
    "EMMREvaluator",
    "RegretBoundEvaluator",
]
