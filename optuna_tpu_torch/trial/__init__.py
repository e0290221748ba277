"""Trial package (reference ``optuna/trial/__init__.py``)."""

from optuna_tpu_torch.trial._base import BaseTrial, _register_concrete_trials
from optuna_tpu_torch.trial._fixed import FixedTrial
from optuna_tpu_torch.trial._frozen import FrozenTrial, create_trial
from optuna_tpu_torch.trial._state import TrialState
from optuna_tpu_torch.trial._trial import Trial

__all__ = ["BaseTrial", "FixedTrial", "FrozenTrial", "Trial", "TrialState", "create_trial"]

_register_concrete_trials()
