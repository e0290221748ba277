"""Drop-in module path alias (reference ``optuna/terminator/improvement/emmr.py``)."""

from optuna_tpu_torch.terminator._evaluators import EMMREvaluator

__all__ = ["EMMREvaluator"]
