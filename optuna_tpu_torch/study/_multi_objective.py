"""Pareto-front and domination helpers.

Parity target: ``optuna/study/_multi_objective.py`` (``_get_pareto_front_trials:43``,
``_fast_non_domination_rank:49``, ``_dominates:222``). The rank computation is
vectorized NumPy on the host for small populations and delegates to the
dominance kernel in :mod:`optuna_tpu_torch.ops.pareto` for large ones.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def _normalize_values(
    objective_values: np.ndarray, directions: Sequence[StudyDirection]
) -> np.ndarray:
    """Flip MAXIMIZE columns so that smaller is always better."""
    values = np.asarray(objective_values, dtype=np.float64).copy()
    for i, d in enumerate(directions):
        if d == StudyDirection.MAXIMIZE:
            values[:, i] *= -1
    return values


#: Feasible points from which the ranking runs on the device (the
#: reference's threshold, ``optuna_tpu/study/_multi_objective.py:115``).
_DEVICE_RANK_MIN_POINTS = 512


def _dominates_values(v0: np.ndarray, v1: np.ndarray) -> bool:
    """Minimization-normalized domination: v0 dominates v1."""
    if np.any(np.isnan(v0)):
        return False
    if np.any(np.isnan(v1)):
        return True
    return bool(np.all(v0 <= v1) and np.any(v0 < v1))


def _dominates(
    trial0: FrozenTrial, trial1: FrozenTrial, directions: Sequence[StudyDirection]
) -> bool:
    """Whether trial0 dominates trial1 (reference ``_multi_objective.py:222``)."""
    values0 = trial0.values
    values1 = trial1.values
    if trial0.state != TrialState.COMPLETE:
        return False
    if trial1.state != TrialState.COMPLETE:
        return True
    assert values0 is not None and values1 is not None
    if len(values0) != len(directions) or len(values1) != len(directions):
        raise ValueError("Trials with different numbers of objectives cannot be compared.")
    v0 = _normalize_values(np.asarray([values0]), directions)[0]
    v1 = _normalize_values(np.asarray([values1]), directions)[0]
    return _dominates_values(v0, v1)


def _fast_non_domination_rank(
    objective_values: np.ndarray,
    *,
    penalty: np.ndarray | None = None,
    n_below: int | None = None,
    device=None,
) -> np.ndarray:
    """Non-domination rank per point (0 = Pareto front), minimization convention.

    Constrained two-tier ranking as in the reference (``:49-168``): feasible
    points always outrank infeasible ones; infeasible points are ranked by
    total constraint violation. Points with NaN objectives get the worst rank.
    Computation stops once ``n_below`` points have been ranked (the TPE/HSSP
    consumers only need the top slice). ``device`` is where the ranking of
    at least :data:`_DEVICE_RANK_MIN_POINTS` feasible points runs (``None``:
    the card); it is resolved only on that branch.
    """
    objective_values = np.asarray(objective_values, dtype=np.float64)
    n = len(objective_values)
    ranks = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return ranks
    n_below = n if n_below is None else min(n_below, n)

    is_nan = np.any(np.isnan(objective_values), axis=1)
    if penalty is None:
        feasible = ~is_nan
        infeasible_order = np.array([], dtype=np.int64)
        nan_mask = is_nan
    else:
        penalty = np.asarray(penalty, dtype=np.float64)
        if len(penalty) != n:
            raise ValueError(
                "The length of penalty and objective_values must be same, but got "
                f"{len(penalty)} and {n}."
            )
        violation = np.where(np.isnan(penalty), np.inf, np.maximum(penalty, 0.0))
        feasible = (~is_nan) & (violation <= 0) & ~np.isnan(penalty)
        nan_mask = is_nan | (np.isnan(penalty) & ~is_nan)
        infeasible = ~feasible & ~nan_mask
        infeasible_order = np.argsort(violation[infeasible], kind="stable")
        infeasible_order = np.flatnonzero(infeasible)[infeasible_order]

    # Tier 1: feasible points ranked by non-domination. Large populations go
    # through the dominance kernel (ops/pareto.py); host NumPy keeps small n,
    # where one device round trip costs more than the whole sort. The
    # threshold is the reference's, measured on a TPU; chip_smoke.py prints
    # the host and device times around it on the card. The device result is
    # a full ranking, a strict refinement of the host path's early-stopped
    # one: every consumer iterates ranks from 0 and stops at its own budget,
    # so both agree on the prefix that matters.
    feas_idx = np.flatnonzero(feasible)
    values = objective_values[feas_idx]
    if len(feas_idx) >= _DEVICE_RANK_MIN_POINTS:
        from optuna_tpu_torch.ops.pareto import non_domination_rank_np

        device_ranks = non_domination_rank_np(values, device=device)
        ranks[feas_idx] = device_ranks
        rank = int(device_ranks.max()) + 1 if len(device_ranks) else 0
        remaining = np.array([], dtype=np.int64)
    else:
        rank = 0
        remaining = np.arange(len(feas_idx))
    n_ranked = 0
    while len(remaining) > 0 and n_ranked < n_below:
        vals = values[remaining]
        # domination matrix: dom[i, j] = i dominates j
        leq = np.all(vals[:, None, :] <= vals[None, :, :], axis=2)
        lt = np.any(vals[:, None, :] < vals[None, :, :], axis=2)
        dom = leq & lt
        dominated = np.any(dom, axis=0)
        front = remaining[~dominated]
        ranks[feas_idx[front]] = rank
        n_ranked += len(front)
        remaining = remaining[dominated]
        rank += 1
    if len(remaining) > 0:
        # Once n_below points are ranked the rest share the (current) worst
        # rank — never the -1 sentinel, which would sort *before* rank 0.
        ranks[feas_idx[remaining]] = rank
        rank += 1

    # Tier 2: infeasible ranked after all feasible, by violation magnitude.
    if len(infeasible_order) > 0:
        base = rank
        prev = None
        r = base - 1
        assert penalty is not None
        violation = np.where(np.isnan(penalty), np.inf, np.maximum(penalty, 0.0))
        for idx in infeasible_order:
            v = violation[idx]
            if prev is None or v > prev:
                r += 1
                prev = v
            ranks[idx] = r
        rank = r + 1

    # Tier 3: NaN objectives (or NaN penalty) are worst.
    ranks[nan_mask] = rank
    return ranks


def _is_pareto_front(values: np.ndarray, assume_unique_lexsorted: bool = False) -> np.ndarray:
    """Boolean mask of non-dominated rows (minimization convention)
    (reference ``_multi_objective.py:171``)."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=bool)
    on_front = np.ones(n, dtype=bool)
    leq = np.all(values[:, None, :] <= values[None, :, :], axis=2)
    lt = np.any(values[:, None, :] < values[None, :, :], axis=2)
    dom = leq & lt
    on_front = ~np.any(dom, axis=0)
    return on_front


def _get_pareto_front_trials_by_trials(
    trials: Sequence[FrozenTrial],
    directions: Sequence[StudyDirection],
    consider_constraint: bool = False,
) -> list[FrozenTrial]:
    from optuna_tpu_torch.study._constrained_optimization import _is_feasible

    complete = [t for t in trials if t.state == TrialState.COMPLETE]
    if consider_constraint:
        complete = [t for t in complete if _is_feasible(t.system_attrs)]
    if len(complete) == 0:
        return []
    values = _normalize_values(
        np.asarray([t.values for t in complete], dtype=np.float64), directions
    )
    nan_rows = np.any(np.isnan(values), axis=1)
    mask = _is_pareto_front(np.where(nan_rows[:, None], np.inf, values))
    mask &= ~nan_rows
    return [t for t, m in zip(complete, mask) if m]


def _get_pareto_front_trials(
    study: "Study", consider_constraint: bool = False
) -> list[FrozenTrial]:
    return _get_pareto_front_trials_by_trials(
        study.trials, study.directions, consider_constraint
    )
