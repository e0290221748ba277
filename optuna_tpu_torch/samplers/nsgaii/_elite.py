"""Elite population selection for NSGA-II: nondominated sort + crowding.

Parity target: ``optuna/samplers/nsgaii/_elite_population_selection_strategy.py``
(rank selection ``:23``, crowding-distance truncation ``:66,120``) with
constrained domination (``nsgaii/_constraints_evaluation.py:19``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from optuna_tpu_torch.study._multi_objective import _fast_non_domination_rank, _normalize_values
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def _constraint_penalty(trials: Sequence[FrozenTrial]) -> np.ndarray | None:
    """Total violation per trial, or None when no trial carries constraints."""
    from optuna_tpu_torch.study._constrained_optimization import _constraints_list

    rows = [_constraints_list(t.system_attrs) for t in trials]
    if all(r is None for r in rows):
        return None
    penalty = np.empty(len(trials))
    for i, constraints in enumerate(rows):
        if constraints is None:
            penalty[i] = np.nan  # missing constraints rank behind infeasible
        else:
            penalty[i] = sum(max(c, 0.0) for c in constraints)
    return penalty


def crowding_distance(values: np.ndarray) -> np.ndarray:
    """Crowding distance per point (inf at objective extremes).

    Fully vectorized over objectives: one (n, m) argsort, per-column gap
    computation, and a scatter back to original order — no per-objective
    Python loop."""
    n, m = values.shape
    if n <= 2:
        return np.full(n, np.inf)
    order = np.argsort(values, axis=0, kind="stable")  # (n, m)
    sorted_vals = np.take_along_axis(values, order, axis=0)
    span = sorted_vals[-1] - sorted_vals[0]  # (m,)
    contrib_sorted = np.zeros((n, m))
    safe_span = np.where(span > 0, span, 1.0)
    contrib_sorted[1:-1] = np.where(
        span > 0, (sorted_vals[2:] - sorted_vals[:-2]) / safe_span, 0.0
    )
    contrib_sorted[0] = contrib_sorted[-1] = np.inf
    contrib = np.zeros((n, m))
    np.put_along_axis(contrib, order, contrib_sorted, axis=0)
    return contrib.sum(axis=1)


def select_elite_population(
    study: "Study", trials: list[FrozenTrial], population_size: int, *, device=None
) -> list[FrozenTrial]:
    """Rank ``trials`` and keep ``population_size`` of them, filling the
    boundary rank by crowding distance. ``device`` is where a ranking of at
    least ``_DEVICE_RANK_MIN_POINTS`` feasible trials runs."""
    if len(trials) <= population_size:
        return list(trials)
    values = _normalize_values(
        np.asarray([t.values for t in trials], dtype=np.float64), study.directions
    )
    penalty = _constraint_penalty(trials)
    ranks = _fast_non_domination_rank(
        values, penalty=penalty, n_below=population_size, device=device
    )

    elite_idx: list[int] = []
    for r in np.unique(ranks):
        members = np.flatnonzero(ranks == r)
        if len(elite_idx) + len(members) <= population_size:
            elite_idx.extend(members.tolist())
            continue
        k = population_size - len(elite_idx)
        if k > 0:
            # Boundary rank: keep the k most spread-out members.
            dist = crowding_distance(values[members])
            keep = members[np.argsort(-dist, kind="stable")[:k]]
            elite_idx.extend(keep.tolist())
        break
    return [trials[i] for i in elite_idx]
