"""optuna_tpu_torch — the PyTorch/CUDA port of ``optuna_tpu``.

The port runs beside the JAX package, which stays the reference. This slice
carries the GPSampler main path: ``create_study`` → ``Study.optimize`` →
``GPSampler`` (exact and SGPR engines) on in-memory storage, with the
Matérn-5/2 cross-covariance as a hand-written CUDA kernel for Hopper.
Numerical entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU they raise instead of moving to the CPU.
"""

from optuna_tpu_torch import _device  # noqa: F401  (TF32 off before any tensor work)
from optuna_tpu_torch import distributions, exceptions, logging, pruners, samplers
from optuna_tpu_torch import search_space, storages, study, trial
from optuna_tpu_torch.exceptions import TrialPruned
from optuna_tpu_torch.study import Study, StudyDirection, create_study
from optuna_tpu_torch.trial import FrozenTrial, Trial, TrialState, create_trial

__all__ = [
    "FrozenTrial",
    "Study",
    "StudyDirection",
    "Trial",
    "TrialPruned",
    "TrialState",
    "create_study",
    "create_trial",
    "distributions",
    "exceptions",
    "logging",
    "pruners",
    "samplers",
    "search_space",
    "storages",
    "study",
    "trial",
]
