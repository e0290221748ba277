"""PED-ANOVA importance (reference ``optuna/importance/_ped_anova/``).

Algorithm (PED-ANOVA, arXiv:2304.10255; conditional extension per
arXiv:2601.20800): the importance of a parameter is the Pearson divergence
between the distribution of its values among the top-``target_quantile``
trials and among the ``region_quantile`` trials, computed on a discretized
grid with a weighted Scott-bandwidth Parzen estimator. Conditional
(define-by-run) parameters are split into *regimes* — one per distinct
distribution object — and the per-regime divergences combine with
``alpha_i^2 / beta_i`` weights.

All density math here is dense NumPy over small grids (<= 50 cells), so it
is cheap on host; nothing in this module needs the accelerator.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import TYPE_CHECKING, Callable

import numpy as np

from optuna_tpu_torch.importance._base import BaseImportanceEvaluator
from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    import torch

    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._frozen import FrozenTrial

_logger = get_logger(__name__)

_N_STEPS = 50
_PRIOR_WEIGHT = 1.0
_MIN_TRIALS_IN_REGIME = 2
# 1.64 sigma (~90% mass) must fit inside one grid cell at minimum bandwidth.
_SIGMA_MIN = 0.5 / 1.64


def _normal_cdf(x: np.ndarray) -> np.ndarray:
    from scipy.special import ndtr

    return ndtr(x)


def _grid_counts(
    param: str, dist: BaseDistribution, trials: list["FrozenTrial"]
) -> np.ndarray:
    """Histogram of the param's values over the discretized domain."""
    if isinstance(dist, CategoricalDistribution):
        idx = [int(dist.to_internal_repr(t.params[param])) for t in trials]
        return np.bincount(idx, minlength=len(dist.choices))
    assert isinstance(dist, (FloatDistribution, IntDistribution))
    n_steps = _N_STEPS
    if isinstance(dist, IntDistribution) and dist.log:
        n_steps = min(int(np.ceil(np.log2(dist.high - dist.low + 1))) + 1, n_steps)
    elif dist.step is not None and not dist.log:
        n_steps = min(round((dist.high - dist.low) / dist.step) + 1, n_steps)
    if dist.log:
        low, high = math.log(dist.low), math.log(dist.high)
        vals = np.log([t.params[param] for t in trials])
    else:
        low, high = float(dist.low), float(dist.high)
        vals = np.asarray([float(t.params[param]) for t in trials])
    cell = (high - low) / (n_steps - 1)
    # Midpoint ties round down, matching the reference's grid snapping.
    idx = np.clip(np.ceil((vals - low) / cell - 0.5).astype(int), 0, n_steps - 1)
    return np.bincount(idx, minlength=n_steps)


def _numerical_grid_pdf(counts: np.ndarray, prior_weight: float) -> np.ndarray:
    """Mixture of discretized truncated normals centred on the occupied grid
    cells (weights = occupancy counts) plus one wide prior component,
    bandwidth by weighted Scott's rule with an IQR guard."""
    size = counts.size
    obs = np.flatnonzero(counts).astype(np.float64)
    w = counts[np.flatnonzero(counts)].astype(np.float64)
    w_cum = np.cumsum(w)
    w_sum = w_cum[-1]

    mean = float(obs @ w) / w_sum
    sigma = math.sqrt(float(((obs - mean) ** 2) @ w) / max(1.0, w_sum - 1.0))
    q1 = int(np.searchsorted(w_cum, w_sum // 4, side="left"))
    q3 = int(np.searchsorted(w_cum, w_sum * 3 // 4, side="right"))
    iqr = obs[min(obs.size - 1, q3)] - obs[q1]
    sigma = 1.059 * min(iqr / 1.34, sigma) * w_sum ** -0.2
    sigma = max(sigma, _SIGMA_MIN)

    low, high = 0.0, float(size - 1)
    mus = np.r_[obs, (low + high) / 2.0]
    sigmas = np.r_[np.full(obs.size, sigma), high - low + 1.0]
    weights = np.r_[w, prior_weight]
    weights = weights / weights.sum()

    grid = np.arange(size, dtype=np.float64)
    upper = _normal_cdf((grid[None, :] + 0.5 - mus[:, None]) / sigmas[:, None])
    lower = _normal_cdf((grid[None, :] - 0.5 - mus[:, None]) / sigmas[:, None])
    z = _normal_cdf((high + 0.5 - mus) / sigmas) - _normal_cdf((low - 0.5 - mus) / sigmas)
    comp = (upper - lower) / np.maximum(z, 1e-300)[:, None]  # (K, size)
    return weights @ comp


def _categorical_grid_pdf(counts: np.ndarray, prior_weight: float) -> np.ndarray:
    """Weighted smoothed-one-hot mixture, exactly the TPE categorical kernel
    with predetermined (count) weights plus the uniform prior row."""
    C = counts.size
    obs = np.flatnonzero(counts)
    w = counts[obs].astype(np.float64)
    n_kernels = obs.size + 1
    rows = np.full((n_kernels, C), prior_weight / n_kernels)
    rows[np.arange(obs.size), obs] += 1.0
    rows /= rows.sum(axis=1, keepdims=True)
    weights = np.r_[w, prior_weight]
    weights = weights / weights.sum()
    return weights @ rows


def _pearson_divergence(
    param: str,
    dist: BaseDistribution,
    target_trials: list["FrozenTrial"],
    region_trials: list["FrozenTrial"],
    evaluate_on_local: bool,
) -> float:
    counts_top = _grid_counts(param, dist, target_trials)
    if isinstance(dist, CategoricalDistribution):
        pdf_top = _categorical_grid_pdf(counts_top, _PRIOR_WEIGHT) + 1e-12
        if evaluate_on_local:
            pdf_region = (
                _categorical_grid_pdf(_grid_counts(param, dist, region_trials), _PRIOR_WEIGHT)
                + 1e-12
            )
        else:
            pdf_region = np.full(counts_top.size, 1.0 / counts_top.size)
    else:
        pdf_top = _numerical_grid_pdf(counts_top, _PRIOR_WEIGHT) + 1e-12
        if evaluate_on_local:
            counts_region = _grid_counts(param, dist, region_trials)
            pdf_region = _numerical_grid_pdf(counts_region, _PRIOR_WEIGHT) + 1e-12
        else:
            pdf_region = np.full(counts_top.size, 1.0 / counts_top.size)
    return float(pdf_region @ ((pdf_top / pdf_region - 1.0) ** 2))


class PedAnovaImportanceEvaluator(BaseImportanceEvaluator):
    """Importance of each parameter for reaching the top-quantile outcomes.

    API parity: reference ``PedAnovaImportanceEvaluator(target_quantile=0.1,
    region_quantile=1.0, evaluate_on_local=True)``; ``baseline_quantile`` is
    accepted as a legacy alias for ``target_quantile``. ``device`` is where a
    multi-objective study's split ranks its trials (``None``: the card, from
    512 trials); the rest is host NumPy.
    """

    def __init__(
        self,
        *,
        target_quantile: float = 0.1,
        region_quantile: float = 1.0,
        evaluate_on_local: bool = True,
        baseline_quantile: float | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        if baseline_quantile is not None:
            target_quantile = baseline_quantile
        if not (0.0 < target_quantile < region_quantile <= 1.0):
            raise ValueError(
                "0.0 < target_quantile < region_quantile <= 1.0 must hold "
                f"(got {target_quantile}, {region_quantile})."
            )
        self._target_quantile = target_quantile
        self._region_quantile = region_quantile
        self._evaluate_on_local = evaluate_on_local
        self._device = device  # the multi-objective split's ranking (K2 from 512 trials)

    # ---------------------------------------------------------------- helpers

    def _top_quantile(
        self,
        study: "Study",
        trials: list["FrozenTrial"],
        quantile: float,
        target: Callable | None,
    ) -> list["FrozenTrial"]:
        if quantile >= 1.0:
            return trials
        if study._is_multi_objective() and target is None:
            # Pareto-preference-free selection: nondomination rank with HSSP
            # tie-breaking, like multi-objective TPE's below-split.
            from optuna_tpu_torch.samplers._tpe.sampler import (
                _split_complete_trials_multi_objective,
            )

            n_below = math.ceil(quantile * len(trials))
            below, _ = _split_complete_trials_multi_objective(
                trials, study, n_below, device=self._device
            )
            return below
        lower_better = study.directions[0] == StudyDirection.MINIMIZE
        if target is not None:
            lower_better = True
        sign = 1.0 if lower_better else -1.0
        losses = sign * np.asarray(
            [t.value if target is None else target(t) for t in trials], dtype=np.float64
        )
        cutoff_index = int(math.ceil(quantile * losses.size)) - 1
        cutoff = float(np.partition(losses, cutoff_index)[cutoff_index])
        return [t for t, keep in zip(trials, losses <= cutoff) if keep]

    # --------------------------------------------------------------- evaluate

    def evaluate(
        self,
        study: "Study",
        params: list[str] | None = None,
        *,
        target: Callable | None = None,
    ) -> dict[str, float]:
        trials = [
            t
            for t in study.get_trials(deepcopy=False, states=(TrialState.COMPLETE,))
            if (
                math.isfinite(target(t))
                if target is not None
                else all(math.isfinite(v) for v in t.values)
            )
        ]
        all_params = sorted({k for t in trials for k in t.distributions})
        if params is None:
            params = all_params
        elif missing := [p for p in params if p not in all_params]:
            raise ValueError(f"No completed trial has parameters {missing}.")
        if len(trials) <= 1:
            _logger.warning("Too few trials for PED-ANOVA; importances are all zero.")
            return {p: 0.0 for p in params}

        target_trials = self._top_quantile(study, trials, self._target_quantile, target)
        region_trials = self._top_quantile(study, trials, self._region_quantile, target)
        if not target_trials:
            return {p: 0.0 for p in params}
        target_ids = {t._trial_id for t in target_trials}

        gamma_ratio = len(target_trials) / len(region_trials)
        importances = {p: 0.0 for p in params}
        for p in params:
            regimes: dict[BaseDistribution | None, list] = defaultdict(list)
            for t in region_trials:
                regimes[t.distributions.get(p)].append(t)
            for dist, regime_trials in regimes.items():
                if len(regime_trials) < _MIN_TRIALS_IN_REGIME:
                    continue
                regime_target = [t for t in regime_trials if t._trial_id in target_ids]
                if dist is None or dist.single() or not regime_target:
                    continue
                alpha = len(regime_target) / len(target_trials)
                beta = len(regime_trials) / len(region_trials)
                importances[p] += (alpha**2 / beta) * _pearson_divergence(
                    p, dist, regime_target, regime_trials, self._evaluate_on_local
                )
        importances = {p: v * gamma_ratio**2 for p, v in importances.items()}
        return dict(sorted(importances.items(), key=lambda kv: kv[1], reverse=True))
