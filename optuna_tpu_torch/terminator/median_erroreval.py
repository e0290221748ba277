"""Drop-in module path alias (reference ``optuna/terminator/median_erroreval.py``)."""

from optuna_tpu_torch.terminator._evaluators import MedianErrorEvaluator

__all__ = ["MedianErrorEvaluator"]
