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


class StaleLeaseError(StorageInternalError):
    """A hub's serve-state write was rejected by the study-ownership fence:
    the write carried a fencing epoch older than the lease persisted in the
    shared storage (``lease:study:<id>``) — the study was re-homed while
    this hub was partitioned, paused, or otherwise declared dead.

    Deliberately NOT a ``TransientStorageError``: retrying the same write
    with the same epoch can never succeed. The raising hub self-demotes
    (stops writing serve state, defers asks to the lease owner, re-acquires
    with a bumped epoch only when the ring prefers it again); the write
    itself is dropped, never re-driven.
    """

    def __init__(
        self,
        study_id: "int | str",
        *,
        held_epoch: int = 0,
        fence_epoch: int = 0,
        owner: str | None = None,
    ) -> None:
        # The gRPC wire rematerializes allow-listed errors as ``cls(msg)``
        # (``_grpc/_service.py::_ERROR_TYPES``): a str first argument is a
        # pre-rendered message from the far side, structured fields lost.
        if isinstance(study_id, str):
            message = study_id
            study_id = -1
        else:
            message = (
                f"stale lease for study {study_id}: write carried epoch "
                f"{held_epoch} but the persisted lease is at epoch {fence_epoch}"
                + (f" (owner {owner!r})" if owner else "")
            )
        super().__init__(message)
        self.study_id = study_id
        self.held_epoch = held_epoch
        self.fence_epoch = fence_epoch
        self.owner = owner


class UpdateFinishedTrialError(OptunaTPUError, RuntimeError):
    """Raised on attempts to mutate a finished (COMPLETE/PRUNED/FAIL) trial.

    Also a ``RuntimeError`` so callers written against the reference's
    documented storage contract (``optuna/exceptions.py:84``) catch it."""


class ExperimentalWarning(Warning):
    """Warning category for experimental APIs."""
