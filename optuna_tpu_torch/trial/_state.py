"""Trial lifecycle states (reference ``optuna/trial/_state.py:7``)."""

from __future__ import annotations

import enum


class TrialState(enum.IntEnum):
    """State machine: WAITING -> RUNNING -> {COMPLETE, PRUNED, FAIL}.

    WAITING trials come from ``study.enqueue_trial`` / retry callbacks and are
    claimed by workers through a storage compare-and-set (see
    ``Study._pop_waiting_trial_id``).
    """

    RUNNING = 0
    COMPLETE = 1
    PRUNED = 2
    FAIL = 3
    WAITING = 4

    def is_finished(self) -> bool:
        return self in (TrialState.COMPLETE, TrialState.PRUNED, TrialState.FAIL)

    def __repr__(self) -> str:
        return f"TrialState.{self.name}"
