"""Exception hierarchy.

Parity target: ``optuna/exceptions.py`` in the reference (TrialPruned,
StorageInternalError, DuplicatedStudyError, UpdateFinishedTrialError,
ExperimentalWarning).
"""

from __future__ import annotations


class OptunaTPUError(Exception):
    """Base class for every exception raised by this framework."""


# Drop-in name for code written against the reference's `OptunaError`.
OptunaError = OptunaTPUError


class TrialPruned(OptunaTPUError):
    """Raised inside an objective to signal that the trial was pruned.

    Raising this exception is the cooperative pruning protocol: the optimize
    loop catches it and records the trial as ``TrialState.PRUNED`` rather
    than ``FAIL`` (reference: ``optuna/exceptions.py:20``).
    """


class CLIUsageError(OptunaTPUError):
    """Raised when CLI arguments are invalid."""


class StorageInternalError(OptunaTPUError):
    """Raised when a storage backend hits an unrecoverable internal error."""


class DuplicatedStudyError(OptunaTPUError):
    """Raised when a study name already exists and ``load_if_exists=False``."""


class UpdateFinishedTrialError(OptunaTPUError, RuntimeError):
    """Raised on attempts to mutate a finished (COMPLETE/PRUNED/FAIL) trial.

    Also a ``RuntimeError`` so callers written against the reference's
    documented storage contract (``optuna/exceptions.py:84``) catch it."""


class ExperimentalWarning(Warning):
    """Warning category for experimental APIs."""
