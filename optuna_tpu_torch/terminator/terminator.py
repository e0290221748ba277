"""Drop-in module path alias (reference ``optuna/terminator/terminator.py``)."""

from optuna_tpu_torch.terminator._terminator import BaseTerminator, Terminator

__all__ = ["BaseTerminator", "Terminator"]
