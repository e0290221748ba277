"""Improvement and error evaluators for the terminator."""

from __future__ import annotations

import abc
import math
from typing import TYPE_CHECKING

import numpy as np

from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.search_space import intersection_search_space
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    import torch

    from optuna_tpu_torch.trial._trial import Trial

_logger = get_logger(__name__)

_CROSS_VALIDATION_SCORES_KEY = "terminator:cv_scores"
DEFAULT_MIN_N_TRIALS = 20


class BaseImprovementEvaluator(abc.ABC):
    @abc.abstractmethod
    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        raise NotImplementedError


class BaseErrorEvaluator(abc.ABC):
    @abc.abstractmethod
    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        raise NotImplementedError


def _complete_trials(trials: list[FrozenTrial]) -> list[FrozenTrial]:
    return [t for t in trials if t.state == TrialState.COMPLETE and t.value is not None]


def _gp_inputs(
    complete: list[FrozenTrial], study_direction: StudyDirection
) -> tuple[list[FrozenTrial], np.ndarray, np.ndarray, np.ndarray, float] | None:
    """The GP evaluators' host inputs, as the reference builds them: the
    trials holding every non-single parameter, their normalized points
    (float32), standardized internal scores (maximized, float32), the
    categorical mask and the score's standard deviation; None where no
    parameter varies."""
    from optuna_tpu_torch.gp.search_space import SearchSpace

    space_dict = {
        k: v for k, v in intersection_search_space(complete).items() if not v.single()
    }
    if not space_dict:
        return None
    space = SearchSpace(space_dict)
    complete = [t for t in complete if all(p in t.params for p in space_dict)]
    X = space.normalize([t.params for t in complete]).astype(np.float32)
    values = np.asarray([t.value for t in complete], dtype=np.float64)
    score = values if study_direction == StudyDirection.MAXIMIZE else -values
    mu, sd = float(np.mean(score)), float(np.std(score))
    sd = sd if sd > 1e-12 else 1.0
    y = ((score - mu) / sd).astype(np.float32)
    return complete, X, y, np.asarray(space.is_categorical), sd


def _posterior_np(state, X: np.ndarray, cat: np.ndarray, dev) -> tuple[np.ndarray, np.ndarray]:
    """The fitted GP's posterior mean and variance at X, on ``dev``, read
    back to float32 NumPy in one copy."""
    import torch

    from optuna_tpu_torch.gp.gp import posterior, upload

    with torch.no_grad():
        mean, var = posterior(state, upload(X, dev), upload(cat, dev, torch.bool))
        both = torch.stack([mean, var]).cpu().numpy()
    return both[0], both[1]


class RegretBoundEvaluator(BaseImprovementEvaluator):
    """GP-UCB simple-regret bound: max UCB - max LCB over observed points
    (reference ``terminator/improvement/evaluator.py:97``), computed with the
    framework's own GP on ``device`` (``None``: the card). Above
    ``gp.sparse.N_EXACT_MAX`` trials the fit is the SGPR engine's (K1 once)."""

    def __init__(
        self, min_n_trials: int = DEFAULT_MIN_N_TRIALS, device: "str | torch.device | None" = None
    ) -> None:
        self._min_n_trials = min_n_trials
        self._device = device

    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        from optuna_tpu_torch._device import resolve_device
        from optuna_tpu_torch.gp.gp import fit_gp

        complete = _complete_trials(trials)
        if len(complete) < self._min_n_trials:
            return float("inf")
        inputs = _gp_inputs(complete, study_direction)
        if inputs is None:
            return float("inf")
        complete, X, y, cat, sd = inputs
        dev = resolve_device(self._device)

        state, _, _ = fit_gp(X, y, cat, seed=0, device=dev)
        # beta from the GP-UCB analysis (reference uses beta = 2 log(d n^2 ...)).
        n, d = X.shape
        beta = 2.0 * math.log(max(d * n * n, 2))
        mean, var = _posterior_np(state, X, cat, dev)
        mean = mean[: len(complete)]
        sigma = np.sqrt(var[: len(complete)])
        ucb = float(np.max(mean + math.sqrt(beta) * sigma))
        lcb = float(np.max(mean - math.sqrt(beta) * sigma))
        return (ucb - lcb) * sd  # back to the objective's scale


class BestValueStagnationEvaluator(BaseImprovementEvaluator):
    """Steps since the best value last improved (reference ``evaluator.py:196``)."""

    def __init__(self, max_stagnation_trials: int = 30) -> None:
        if max_stagnation_trials < 0:
            raise ValueError("max_stagnation_trials must be nonnegative.")
        self._max_stagnation_trials = max_stagnation_trials

    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        complete = _complete_trials(trials)
        if not complete:
            return float("inf")
        maximize = study_direction == StudyDirection.MAXIMIZE
        best_i = 0
        best_v = complete[0].value
        for i, t in enumerate(complete):
            assert t.value is not None
            if (maximize and t.value > best_v) or (not maximize and t.value < best_v):
                best_i, best_v = i, t.value
        stagnation = len(complete) - 1 - best_i
        return float(self._max_stagnation_trials - stagnation)


def _emmr_normals(n_samples: int, n: int, seed: int) -> np.ndarray:
    """EMMR's (n_samples, n) float32 standard normals, from a CPU
    ``torch.Generator`` seeded with ``seed``: the card and the CPU see the
    same draws. The reference draws ``jax.random.normal(PRNGKey(seed), ...)``,
    a stream the port cannot reproduce; the parity tests hand it in here."""
    import torch

    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(n_samples, n, generator=gen, dtype=torch.float32).numpy()


class EMMREvaluator(BaseImprovementEvaluator):
    """Expected minimum model regret (reference ``improvement/emmr.py:43``):
    MC estimate of E[min posterior] improvement between successive models —
    approximated here by the posterior-sample minimum gap on observed points.
    Both GP fits run on ``device`` (``None``: the card)."""

    def __init__(
        self,
        min_n_trials: int = DEFAULT_MIN_N_TRIALS,
        n_samples: int = 128,
        seed: int = 0,
        device: "str | torch.device | None" = None,
    ) -> None:
        self._min_n_trials = min_n_trials
        self._n_samples = n_samples
        self._seed = seed
        self._device = device

    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        from optuna_tpu_torch._device import resolve_device
        from optuna_tpu_torch.gp.gp import fit_gp

        complete = _complete_trials(trials)
        if len(complete) < max(self._min_n_trials, 3):
            return float("inf")
        inputs = _gp_inputs(complete, study_direction)
        if inputs is None:
            return float("inf")
        complete, X, y, cat, sd = inputs
        dev = resolve_device(self._device)

        state_now, _, _ = fit_gp(X, y, cat, seed=self._seed, device=dev)
        state_prev, _, _ = fit_gp(X[:-1], y[:-1], cat, seed=self._seed, device=dev)

        mean_n, var_n = _posterior_np(state_now, X, cat, dev)
        mean_p, var_p = _posterior_np(state_prev, X, cat, dev)
        z = _emmr_normals(self._n_samples, len(complete), self._seed)
        samp_n = mean_n[None, : len(complete)] + z * np.sqrt(var_n[None, : len(complete)])
        samp_p = mean_p[None, : len(complete)] + z * np.sqrt(var_p[None, : len(complete)])
        # Internal scores are maximized: regret gap of the model max.
        gap = float(np.mean(np.abs(samp_n.max(axis=1) - samp_p.max(axis=1))))
        return gap * sd


class CrossValidationErrorEvaluator(BaseErrorEvaluator):
    """Variance of reported CV scores scaled by (k+1)/k (reference
    ``erroreval.py``); scores arrive via report_cross_validation_scores."""

    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        maximize = study_direction == StudyDirection.MAXIMIZE
        best = None
        for t in _complete_trials(trials):
            if best is None:
                best = t
            elif maximize and t.value > best.value:
                best = t
            elif not maximize and t.value < best.value:
                best = t
        if best is None:
            return float("nan")
        scores = best.system_attrs.get(_CROSS_VALIDATION_SCORES_KEY)
        if scores is None:
            raise ValueError(
                "Cross-validation scores have not been reported. Use "
                "report_cross_validation_scores(trial, scores) inside the objective."
            )
        k = len(scores)
        if k <= 1:
            raise ValueError("At least two cross-validation scores are required.")
        var = float(np.var(scores, ddof=1))
        return var * (k + 1) / k


class StaticErrorEvaluator(BaseErrorEvaluator):
    def __init__(self, constant: float) -> None:
        self._constant = constant

    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        return self._constant


class MedianErrorEvaluator(BaseErrorEvaluator):
    """Median of a paired improvement evaluator's history scaled by a factor
    (reference ``median_erroreval.py``) — an error proxy when no CV scores exist."""

    def __init__(
        self,
        paired_improvement_evaluator: BaseImprovementEvaluator | None = None,
        warm_up_trials: int = 10,
        n_min_trials: int = 20,
        scale: float = 1.5,
    ) -> None:
        self._paired = paired_improvement_evaluator
        self._warm_up_trials = warm_up_trials
        self._n_min_trials = n_min_trials
        self._scale = scale

    def evaluate(self, trials: list[FrozenTrial], study_direction: StudyDirection) -> float:
        complete = _complete_trials(trials)
        if len(complete) < max(self._warm_up_trials + self._n_min_trials, 2):
            return -float("inf")  # never terminates this early
        trimmed = complete[self._warm_up_trials :]
        if self._paired is not None:
            improvements = [
                self._paired.evaluate(trimmed[: i + 1], study_direction)
                for i in range(self._n_min_trials - 1, len(trimmed))
            ]
            finite = [v for v in improvements if math.isfinite(v)]
            if not finite:
                return -float("inf")
            return self._scale * float(np.median(finite))
        deltas = np.abs(np.diff([t.value for t in trimmed]))
        if len(deltas) == 0:
            return -float("inf")
        return self._scale * float(np.median(deltas))


def report_cross_validation_scores(trial: "Trial", scores: list[float]) -> None:
    """Record per-fold CV scores for CrossValidationErrorEvaluator."""
    if len(scores) <= 1:
        raise ValueError("The number of scores must be greater than one.")
    trial.storage.set_trial_system_attr(
        trial._trial_id, _CROSS_VALIDATION_SCORES_KEY, list(map(float, scores))
    )
