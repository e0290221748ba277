"""Drop-in module path alias (reference ``optuna/terminator/callback.py``)."""

from optuna_tpu_torch.terminator._terminator import TerminatorCallback

__all__ = ["TerminatorCallback"]
