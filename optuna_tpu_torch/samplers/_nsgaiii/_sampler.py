"""NSGA-III: reference-point niching for many-objective optimization (port
of ``optuna_tpu/samplers/_nsgaiii/_sampler.py``).

Parity target: ``optuna/samplers/_nsgaiii/_sampler.py:226`` — Das-Dennis
structured reference points (``_elite_population_selection_strategy.py:107``),
adaptive normalization via ideal point + extreme-point intercepts (``:172``),
association of boundary-rank members to reference lines and niche-count
preserving selection (``:222``). Crowding distance is replaced wholesale.

The elite ranking goes through ``_fast_non_domination_rank(..., device=...)``:
a pool of at least ``_DEVICE_RANK_MIN_POINTS`` feasible trials is ranked on
``device`` (the ranking kernels on the card, K2); the normalisation,
association and niching stay host NumPy, as in the reference.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers.nsgaii._crossovers import BaseCrossover
from optuna_tpu_torch.samplers.nsgaii._elite import _constraint_penalty
from optuna_tpu_torch.samplers.nsgaii._sampler import NSGAIISampler
from optuna_tpu_torch.study._multi_objective import (
    _fast_non_domination_rank,
    _normalize_values,
)
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def generate_default_reference_point(
    n_objectives: int, dividing_parameter: int = 3
) -> np.ndarray:
    """Das-Dennis simplex lattice points (reference ``:107``)."""
    combos = itertools.combinations(
        range(n_objectives + dividing_parameter - 1), n_objectives - 1
    )
    points = []
    for c in combos:
        prev = -1
        coords = []
        for pos in c:
            coords.append(pos - prev - 1)
            prev = pos
        coords.append(n_objectives + dividing_parameter - 2 - prev)
        points.append(coords)
    return np.asarray(points, dtype=np.float64) / dividing_parameter


def _normalize_objectives(values: np.ndarray) -> np.ndarray:
    """ASF-based adaptive normalization (ideal point + intercepts)."""
    n, m = values.shape
    ideal = values.min(axis=0)
    shifted = values - ideal

    # Extreme point per axis via achievement scalarizing function.
    asf_weights = np.full((m, m), 1e-6)
    np.fill_diagonal(asf_weights, 1.0)
    # asf[i, j] = max_k shifted[j, k] / w_i[k]
    asf = np.max(shifted[None, :, :] / asf_weights[:, None, :], axis=2)  # (m, n)
    extreme_idx = np.argmin(asf, axis=1)
    extremes = shifted[extreme_idx]  # (m, m)

    intercepts = np.ones(m)
    try:
        b = np.linalg.solve(extremes, np.ones(m))
        with np.errstate(divide="ignore"):
            cand = 1.0 / b
        if np.all(np.isfinite(cand)) and np.all(cand > 1e-12):
            intercepts = cand
        else:
            raise np.linalg.LinAlgError
    except np.linalg.LinAlgError:
        intercepts = np.maximum(shifted.max(axis=0), 1e-12)
    return shifted / intercepts


def _associate(normalized: np.ndarray, ref_points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(closest reference index, perpendicular distance) per point."""
    norms = np.linalg.norm(ref_points, axis=1, keepdims=True)
    units = ref_points / np.maximum(norms, 1e-12)  # (R, m)
    proj = normalized @ units.T  # (n, R)
    proj_vecs = proj[:, :, None] * units[None, :, :]  # (n, R, m)
    dists = np.linalg.norm(normalized[:, None, :] - proj_vecs, axis=2)  # (n, R)
    idx = np.argmin(dists, axis=1)
    return idx, dists[np.arange(len(normalized)), idx]


def _niching_select(
    selected: list[int],
    boundary: list[int],
    k: int,
    ref_idx: np.ndarray,
    ref_dist: np.ndarray,
    n_refs: int,
    rng: np.random.RandomState,
) -> list[int]:
    """Fill k slots from the boundary rank preserving niche balance
    (reference ``:222``)."""
    niche_count = np.zeros(n_refs, dtype=np.int64)
    for i in selected:
        niche_count[ref_idx[i]] += 1
    pool = list(boundary)
    out: list[int] = []
    while len(out) < k and pool:
        # Least-crowded niche among those represented in the pool.
        pool_niches = {ref_idx[i] for i in pool}
        min_count = min(niche_count[r] for r in pool_niches)
        candidates_niches = [r for r in pool_niches if niche_count[r] == min_count]
        r = candidates_niches[rng.randint(len(candidates_niches))]
        members = [i for i in pool if ref_idx[i] == r]
        if niche_count[r] == 0:
            # Prefer the member closest to the reference line.
            pick = min(members, key=lambda i: ref_dist[i])
        else:
            pick = members[rng.randint(len(members))]
        out.append(pick)
        pool.remove(pick)
        niche_count[r] += 1
    return out


class NSGAIIISampler(NSGAIISampler):
    def __init__(
        self,
        *,
        population_size: int = 50,
        mutation_prob: float | None = None,
        crossover: BaseCrossover | None = None,
        crossover_prob: float = 0.9,
        swapping_prob: float = 0.5,
        seed: int | None = None,
        constraints_func: Callable[[FrozenTrial], Sequence[float]] | None = None,
        reference_points: np.ndarray | None = None,
        dividing_parameter: int = 3,
        device: "str | torch.device | None" = None,
    ) -> None:
        super().__init__(
            population_size=population_size,
            mutation_prob=mutation_prob,
            crossover=crossover,
            crossover_prob=crossover_prob,
            swapping_prob=swapping_prob,
            seed=seed,
            constraints_func=constraints_func,
            elite_population_selection_strategy=self._select_elite_niching,
            device=device,
        )
        self._reference_points = reference_points
        self._dividing_parameter = dividing_parameter
        self._niching_rng = LazyRandomState(seed)

    def _select_elite_niching(
        self, study: "Study", trials: list[FrozenTrial], population_size: int
    ) -> list[FrozenTrial]:
        if len(trials) <= population_size:
            return list(trials)
        values = _normalize_values(
            np.asarray([t.values for t in trials], dtype=np.float64), study.directions
        )
        penalty = _constraint_penalty(trials)
        ranks = _fast_non_domination_rank(
            values, penalty=penalty, n_below=population_size, device=self._device
        )

        m = values.shape[1]
        ref_points = (
            self._reference_points
            if self._reference_points is not None
            else generate_default_reference_point(m, self._dividing_parameter)
        )

        selected: list[int] = []
        for r in np.unique(ranks):
            members = np.flatnonzero(ranks == r).tolist()
            if len(selected) + len(members) <= population_size:
                selected.extend(members)
                continue
            k = population_size - len(selected)
            if k > 0:
                finite = np.all(np.isfinite(values), axis=1)
                safe_vals = np.where(finite[:, None], values, np.nanmax(np.where(np.isfinite(values), values, np.nan), axis=0))
                normalized = _normalize_objectives(safe_vals)
                ref_idx, ref_dist = _associate(normalized, ref_points)
                chosen = _niching_select(
                    selected, members, k, ref_idx, ref_dist, len(ref_points),
                    self._niching_rng.rng,
                )
                selected.extend(chosen)
            break
        return [trials[i] for i in selected]
