"""Constrained-optimization helpers (reference ``optuna/study/_constrained_optimization.py:12-59``).

Protocol: the user passes ``constraints_func(frozen_trial) -> Sequence[float]``
to a sampler; values are stored under the ``constraints`` system attr at
trial end; a trial is feasible iff every component <= 0.
"""

from __future__ import annotations

from typing import Any, Sequence

from optuna_tpu_torch.trial._frozen import FrozenTrial

_CONSTRAINTS_KEY = "constraints"


def _get_constraints_from_system_attrs(system_attrs: dict[str, Any]) -> dict[str, float]:
    """Merge both constraint encodings into one named map.

    The sampler protocol stores a *list* under ``constraints``; the
    user-facing ``trial.set_constraint(key, v)`` API stores individual
    ``constraints:<key>`` entries (reference
    ``_constrained_optimization.py:42``). Named entries win on collision."""
    merged: dict[str, float] = {}
    listed = system_attrs.get(_CONSTRAINTS_KEY)
    if listed is not None:
        for i, c in enumerate(listed):
            merged[str(i)] = float(c)
    prefix = f"{_CONSTRAINTS_KEY}:"
    for key, value in system_attrs.items():
        if key.startswith(prefix):
            merged[key[len(prefix):]] = float(value)
    return merged


def _constraints_list(system_attrs: dict[str, Any]) -> list[float] | None:
    """Every constraint value of a trial as one list (both encodings merged,
    named entries in sorted-key order for cross-trial consistency), or None
    when the trial carries no constraint information at all."""
    has_any = _CONSTRAINTS_KEY in system_attrs or any(
        k.startswith(f"{_CONSTRAINTS_KEY}:") for k in system_attrs
    )
    if not has_any:
        return None
    merged = _get_constraints_from_system_attrs(system_attrs)
    return [merged[k] for k in sorted(merged)]


def _is_feasible(system_attrs: dict[str, Any]) -> bool:
    """No constraints, or every constraint value <= 0."""
    values = _constraints_list(system_attrs)
    return values is None or all(v <= 0.0 for v in values)


def _get_feasible_trials(trials: Sequence[FrozenTrial]) -> list[FrozenTrial]:
    feasible_trials = []
    for trial in trials:
        constraints = _get_constraints_from_system_attrs(trial.system_attrs)
        if all(x <= 0.0 for x in constraints.values()):
            feasible_trials.append(trial)
    return feasible_trials
