"""Tree-structured Parzen Estimator sampler (port of
``optuna_tpu/samplers/_tpe/sampler.py``).

Parity target: ``optuna/samplers/_tpe/sampler.py:86`` (``TPESampler``), with
gamma/weights defaults (``:54-70``), the below/above trial split
(``_split_trials:744``), multivariate + group modes, constant liar for
parallel workers, c-TPE constraint handling, and multi-objective TPE (the
split ranks through K2 on the device from 512 complete feasible trials and
resolves its boundary rank by HSSP; the below weights are leave-one-out
hypervolume contributions).

An ask past the startup trials: the split and the packing of the raw
observations on the host; one host-to-device copy of one packed buffer
(:func:`._kernels.upload_obs`); the draws from a ``torch.Generator`` seeded
by the ask's host seed; the KDE build, draw, score and argmax as batched
torch ops (:mod:`._kernels`); one read of the result. The first half, from
the history read through the upload, is the ``ask.fit`` phase; the second,
from the draws through the read and the decode, is ``ask.propose``.
``device`` (``None``: the card) is resolved at the first ask; nothing moves
TPE to the CPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import warnings
from typing import TYPE_CHECKING, Any, Callable, Sequence

import numpy as np
import torch

from optuna_tpu_torch import telemetry
from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.distributions import BaseDistribution, CategoricalDistribution
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.samplers._base import BaseSampler, _process_constraints_after_trial
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler
from optuna_tpu_torch.samplers._tpe import _kernels
from optuna_tpu_torch.samplers._tpe.parzen_estimator import (
    EPS,
    _bucket,
    _call_weights_func,
    _from_transformed,
    _ParzenEstimatorParameters,
    _transformed_bounds,
)
from optuna_tpu_torch.search_space import IntersectionSearchSpace, _GroupDecomposedSearchSpace
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)

#: Search-space signatures whose constants stay cached (dynamic spaces mint
#: a new signature per trial; a miss costs one host rebuild and upload).
_SPACE_CACHE_MAX = 128


def default_gamma(x: int) -> int:
    """Number of "good" trials: ceil(0.1 n) capped at 25 (reference ``:54``)."""
    return min(int(np.ceil(0.1 * x)), 25)


def hyperopt_default_gamma(x: int) -> int:
    return min(int(np.ceil(0.25 * np.sqrt(x))), 25)


def default_weights(x: int) -> np.ndarray:
    """Flat weights for the newest 25 trials, linear decay for older ones
    (reference ``:60-70``)."""
    if x == 0:
        return np.asarray([])
    if x < 25:
        return np.ones(x)
    ramp = np.linspace(1.0 / x, 1.0, num=x - 25)
    flat = np.ones(25)
    return np.concatenate([ramp, flat], axis=0)


class TPESampler(BaseSampler):
    """On each trial: split history into below (good) / above (rest), fit a
    KDE to each, and suggest the candidate maximizing ``l(x)/g(x)``."""

    def __init__(
        self,
        consider_prior: bool = True,
        prior_weight: float = 1.0,
        consider_magic_clip: bool = True,
        consider_endpoints: bool = False,
        n_startup_trials: int = 10,
        n_ei_candidates: int = 24,
        gamma: Callable[[int], int] = default_gamma,
        weights: Callable[[int], np.ndarray] = default_weights,
        seed: int | None = None,
        *,
        multivariate: bool = False,
        group: bool = False,
        warn_independent_sampling: bool = True,
        constant_liar: bool = False,
        constraints_func: Callable[[FrozenTrial], Sequence[float]] | None = None,
        categorical_distance_func: dict[str, Callable[[Any, Any], float]] | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        self._parzen_estimator_parameters = _ParzenEstimatorParameters(
            consider_prior,
            prior_weight,
            consider_magic_clip,
            consider_endpoints,
            weights,
            multivariate,
            categorical_distance_func or {},
        )
        self._n_startup_trials = n_startup_trials
        self._n_ei_candidates = n_ei_candidates
        self._gamma = gamma
        self._warn_independent_sampling = warn_independent_sampling
        self._rng = LazyRandomState(seed)
        self._random_sampler = RandomSampler(seed=seed)
        self._univariate_space_specs: dict = {}
        self._multivariate = multivariate
        self._group = group
        self._group_decomposed_search_space: _GroupDecomposedSearchSpace | None = None
        self._search_space_group = None
        self._search_space = IntersectionSearchSpace(include_pruned=True)
        self._constant_liar = constant_liar
        self._constraints_func = constraints_func
        self._device_arg = device
        self._device: torch.device | None = None

        if group and not multivariate:
            raise ValueError("`group` option can only be enabled when `multivariate` is enabled.")

    @property
    def device(self) -> torch.device:
        """Where the KDE plane runs: resolved once, at the first ask
        (``None`` → the card, which must exist)."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    def reseed_rng(self) -> None:
        self._rng.seed()
        self._random_sampler.reseed_rng()

    # ----------------------------------------------------------- search space

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        self.device  # noqa: B018  (a missing card raises at the first ask)
        if not self._multivariate:
            # Univariate TPE still claims the intersection space so all dims
            # are suggested in one batched device program (each dim keeps its
            # own 1-D KDE). Params outside it go to sample_independent.
            return {
                name: dist
                for name, dist in self._search_space.calculate(study).items()
                if not dist.single()
            }
        search_space: dict[str, BaseDistribution] = {}
        if self._group:
            if self._group_decomposed_search_space is None:
                self._group_decomposed_search_space = _GroupDecomposedSearchSpace(True)
            self._search_space_group = self._group_decomposed_search_space.calculate(study)
            for sub_space in self._search_space_group.search_spaces:
                for name, dist in sub_space.items():
                    if not dist.single():
                        search_space[name] = dist
            return search_space
        for name, dist in self._search_space.calculate(study).items():
            if not dist.single():
                search_space[name] = dist
        return search_space

    # --------------------------------------------------------------- sampling

    def sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        if self._group:
            assert self._search_space_group is not None
            params: dict[str, Any] = {}
            for sub_space in self._search_space_group.search_spaces:
                space = {name: dist for name, dist in sub_space.items() if name in search_space}
                if len(space) == 0:
                    continue
                params.update(self._sample_relative(study, trial, space))
            return params
        return self._sample_relative(study, trial, search_space)

    def _sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        if search_space == {}:
            return {}
        states = (TrialState.COMPLETE, TrialState.PRUNED)
        trials = study._get_trials(deepcopy=False, states=None, use_cache=not self._constant_liar)
        n = sum(t.state in states for t in trials)
        if n < self._n_startup_trials:
            return {}
        return self._sample(study, search_space, joint=self._multivariate)

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        states = (TrialState.COMPLETE, TrialState.PRUNED)
        trials = study._get_trials(deepcopy=False, states=states, use_cache=True)
        if len(trials) < self._n_startup_trials:
            return self._random_sampler.sample_independent(study, trial, param_name, param_distribution)
        if self._multivariate and self._warn_independent_sampling:
            _logger.warning(
                f"The parameter '{param_name}' in trial#{trial.number} is sampled "
                "independently instead of being sampled by multivariate TPE."
            )
        params = self._sample(study, {param_name: param_distribution}, joint=True)
        return params[param_name]

    def _split(
        self, study: "Study", search_space: dict[str, BaseDistribution], states: tuple, use_cache: bool
    ) -> tuple[list[FrozenTrial], list[FrozenTrial]]:
        trials = study._get_trials(deepcopy=False, states=states, use_cache=use_cache)
        # Keep only trials having every parameter of this (sub)space.
        trials = [t for t in trials if all(p in t.params for p in search_space)]
        n_finished = sum(t.state in (TrialState.COMPLETE, TrialState.PRUNED) for t in trials)
        return _split_trials(
            study, trials, self._gamma(n_finished), self._constraints_func is not None, device=self.device
        )

    def _sample(
        self, study: "Study", search_space: dict[str, BaseDistribution], joint: bool
    ) -> dict[str, Any]:
        """One TPE ask over ``search_space``: every dimension's own 1-D KDE
        (univariate) or one joint KDE (multivariate, and a single param
        sampled independently)."""
        if self._constant_liar:
            states: tuple = (TrialState.COMPLETE, TrialState.PRUNED, TrialState.RUNNING)
        else:
            states = (TrialState.COMPLETE, TrialState.PRUNED)
        with telemetry.span("ask.fit"):
            below_trials, above_trials = self._split(study, search_space, states, not self._constant_liar)
            spec = self._univariate_space_spec(search_space)
            below, above, seed = self._upload(study, spec, below_trials, above_trials)
        with telemetry.span("ask.propose"):
            p = self._parzen_estimator_parameters
            dn, dc = len(spec["num_items"]), len(spec["cat_items"])
            n_comp = below.log_w.shape[0]
            args = (seed, dn, dc, self._n_ei_candidates, n_comp, spec["cat_cmax"], self.device)
            if joint:
                num_out, cat_out = _kernels.sample_and_score_from_obs(
                    below, above, spec["space"], _kernels.joint_draws(*args), p.consider_endpoints
                )
            else:
                num_out, cat_out = _kernels.sample_univariate_from_obs(
                    below, above, spec["space"], _kernels.univariate_draws(*args), p.consider_endpoints
                )
            out = torch.cat([num_out, cat_out.to(num_out.dtype)]).cpu().numpy()  # the ask's one read
            return self._decode(spec, out[:dn], out[dn:])

    def sample_relative_batch(
        self,
        study: "Study",
        search_space: dict[str, BaseDistribution],
        n: int,
    ) -> list[dict[str, Any]] | None:
        """Propose ``n`` joint candidates in one device program: the top ``n``
        of ``max(n_ei_candidates, 4n)`` draws. Returns None (the caller falls
        back to per-trial asks) during startup or for an empty space."""
        if not search_space:
            return None
        with telemetry.span("ask.fit") as fit:
            states = (TrialState.COMPLETE, TrialState.PRUNED)
            trials = study._get_trials(deepcopy=False, states=states, use_cache=False)
            trials = [t for t in trials if all(p in t.params for p in search_space)]
            if len(trials) < self._n_startup_trials:
                fit.cancel()  # a start-up batch: no fit
                return None
            below_trials, above_trials = _split_trials(
                study, trials, self._gamma(len(trials)), self._constraints_func is not None, device=self.device
            )
            spec = self._univariate_space_spec(search_space)
            below, above, seed = self._upload(study, spec, below_trials, above_trials)
        with telemetry.span("ask.propose"):
            p = self._parzen_estimator_parameters
            dn, dc = len(spec["num_items"]), len(spec["cat_items"])
            draws = _kernels.joint_draws(
                seed, dn, dc, max(self._n_ei_candidates, 4 * n), below.log_w.shape[0], spec["cat_cmax"], self.device
            )
            x_num, x_cat = _kernels.sample_and_score_topk_from_obs(
                below, above, spec["space"], draws, n, p.consider_endpoints
            )
            out = torch.cat([x_num, x_cat.to(x_num.dtype)], dim=1).cpu().numpy()
            return [self._decode(spec, row[:dn], row[dn:]) for row in out]

    # ------------------------------------------------------------ host side

    def _univariate_space_spec(self, search_space: dict[str, BaseDistribution]) -> dict:
        """Per-space-signature constants, on the host and on the device.

        Bounded: dynamic search spaces (e.g. per-trial float bounds) mint a
        fresh signature every call, so the cache is capped; a miss costs a
        cheap host rebuild and one upload."""
        key = tuple((n, repr(d)) for n, d in search_space.items())
        # Unlocked on purpose: asks from ``n_jobs`` threads may both miss and
        # build the same spec; each is complete before it is stored, so a
        # race costs one extra build, never a wrong spec.
        spec = self._univariate_space_specs.get(key)
        if spec is not None:
            return spec
        if len(self._univariate_space_specs) >= _SPACE_CACHE_MAX:
            self._univariate_space_specs.clear()
        num_items = [(n, d) for n, d in search_space.items() if not isinstance(d, CategoricalDistribution)]
        cat_items = [(n, d) for n, d in search_space.items() if isinstance(d, CategoricalDistribution)]
        bounds = [_transformed_bounds(d) for _, d in num_items]
        cmax = max((len(d.choices) for _, d in cat_items), default=1)
        # The user's distance callables are evaluated once per space into
        # (C, C) matrices; every per-ask KDE build then runs on the device.
        dist_funcs = self._parzen_estimator_parameters.categorical_distance_func
        dist_mats = np.zeros((len(cat_items), cmax, cmax), np.float32)
        has_dist = np.zeros(len(cat_items), bool)
        for d, (name, dist) in enumerate(cat_items):
            fn = dist_funcs.get(name)
            if fn is None:
                continue
            has_dist[d] = True
            for i, ci in enumerate(dist.choices):
                for j, cj in enumerate(dist.choices):
                    dist_mats[d, i, j] = float(fn(ci, cj))
        spec = {
            "num_items": num_items,
            "cat_items": cat_items,
            "lows": np.asarray([b[0] for b in bounds], np.float32),
            "highs": np.asarray([b[1] for b in bounds], np.float32),
            "steps": np.asarray([b[2] for b in bounds], np.float32),
            "is_log": [b[3] for b in bounds],
            "n_choices": np.asarray([len(d.choices) for _, d in cat_items], np.int32),
            "cat_cmax": cmax,
            "dist_mats": dist_mats,
            "has_dist": has_dist,
        }
        spec["space"] = _kernels.make_space(
            spec["lows"], spec["highs"], spec["steps"], spec["n_choices"], dist_mats, has_dist, self.device
        )
        self._univariate_space_specs[key] = spec
        return spec

    def _pack_observations(
        self,
        study: "Study",
        spec: dict,
        trial_set: list[FrozenTrial],
        below: bool,
    ):
        """Raw padded observations and component log-weights of one KDE set,
        as the reference's program takes them: ``(obs_num (Dn, B), obs_cat
        (Dc, B), log_w (B,), n, n_k)``. The weights stay on the host: the
        weights callable and the MOTPE contributions are host logic."""
        p = self._parzen_estimator_parameters
        num_items, cat_items = spec["num_items"], spec["cat_items"]
        n = len(trial_set)
        if below and study._is_multi_objective():
            w = _calculate_weights_below_for_multi_objective(study, trial_set, device=self.device)
        else:
            w = _call_weights_func(p.weights, n)
        effective_prior = p.consider_prior or n == 0
        if effective_prior:
            # With no below weights (None) the reference's append makes the
            # observation weight NaN; kept as is for parity.
            w = np.append(w, p.prior_weight)
        w = w.astype(np.float64)
        w /= w.sum()
        b = _bucket(n + (1 if effective_prior else 0))
        log_w = np.full(b, -np.inf, np.float32)
        log_w[: len(w)] = np.log(np.maximum(w, EPS))
        obs_num = np.zeros((len(num_items), b), np.float32)
        for d, (name, dist) in enumerate(num_items):
            vals = np.asarray([dist.to_internal_repr(t.params[name]) for t in trial_set], np.float64)
            obs_num[d, :n] = np.log(vals) if spec["is_log"][d] else vals
        obs_cat = np.zeros((len(cat_items), b), np.int32)
        for d, (name, dist) in enumerate(cat_items):
            obs_cat[d, :n] = [int(dist.to_internal_repr(t.params[name])) for t in trial_set]
        return obs_num, obs_cat, log_w, np.int32(n), np.float32(n + (1 if effective_prior else 0))

    def _upload(self, study: "Study", spec: dict, below_trials, above_trials):
        """Both KDE sets on the device (one copy) and the ask's seed."""
        p = self._parzen_estimator_parameters
        sets = [
            self._pack_observations(study, spec, below_trials, below=True),
            self._pack_observations(study, spec, above_trials, below=False),
        ]
        seed = int(self._rng.rng.randint(0, 2**31 - 1))
        below, above = _kernels.upload_obs(
            sets, spec["lows"], spec["highs"], spec["n_choices"], p.prior_weight,
            p.consider_magic_clip, spec["space"].dist_mats is not None, self.device,
        )
        return below, above, seed

    def _decode(self, spec: dict, num_out: np.ndarray, cat_out: np.ndarray) -> dict[str, Any]:
        params: dict[str, Any] = {}
        for d, (name, dist) in enumerate(spec["num_items"]):
            params[name] = dist.to_external_repr(_from_transformed(dist, float(num_out[d])))
        for d, (name, dist) in enumerate(spec["cat_items"]):
            params[name] = dist.to_external_repr(float(int(cat_out[d])))
        return params

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        assert state in [TrialState.COMPLETE, TrialState.FAIL, TrialState.PRUNED]
        if self._constraints_func is not None:
            _process_constraints_after_trial(self._constraints_func, study, trial, state)


class MOTPESampler(TPESampler):
    """Deprecated multi-objective TPE alias (the reference keeps it for
    compatibility): a TPESampler whose defaults match the MOTPE paper."""

    def __init__(
        self,
        *,
        consider_prior: bool = True,
        prior_weight: float = 1.0,
        consider_magic_clip: bool = True,
        consider_endpoints: bool = True,
        n_startup_trials: int = 10,
        n_ehvi_candidates: int = 24,
        gamma: Callable[[int], int] | None = None,
        weights_above: Callable[[int], np.ndarray] | None = None,
        seed: int | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        warnings.warn(
            "MOTPESampler has been deprecated; use TPESampler directly — "
            "multi-objective handling is built in.",
            FutureWarning,
            stacklevel=2,
        )
        super().__init__(
            consider_prior=consider_prior,
            prior_weight=prior_weight,
            consider_magic_clip=consider_magic_clip,
            consider_endpoints=consider_endpoints,
            n_startup_trials=n_startup_trials,
            n_ei_candidates=n_ehvi_candidates,
            gamma=gamma or default_gamma,
            weights=weights_above or default_weights,
            seed=seed,
            device=device,
        )


def _hv_reference_point(worst_point: np.ndarray) -> np.ndarray:
    """Reference point strictly dominated by the worst point on every axis,
    valid for negative coordinates too (normalized MAXIMIZE objectives flip
    sign): max(1.1*w, 0.9*w) moves away from w regardless of sign."""
    return np.maximum(worst_point * 1.1, worst_point * 0.9) + 1e-12


# ------------------------------------------------------------------ splitting


def _get_infeasible_trial_score(trial: FrozenTrial) -> tuple[bool, float]:
    from optuna_tpu_torch.study._constrained_optimization import _constraints_list

    constraint = _constraints_list(trial.system_attrs)
    if constraint is None:
        return True, float("inf")
    violation = sum(v for v in constraint if v > 0)
    return violation > 0, violation


def _split_trials(
    study: "Study",
    trials: list[FrozenTrial],
    n_below: int,
    constraints_enabled: bool,
    *,
    device=None,
) -> tuple[list[FrozenTrial], list[FrozenTrial]]:
    """Partition history into (below, above) — reference ``_split_trials:744``.

    Feasible complete trials are ranked by value (non-domination rank and
    HSSP for multi-objective, on ``device`` where the routes reach it);
    pruned trials fill remaining below slots ranked by (last step desc,
    value); infeasible and RUNNING (constant-liar) trials always land above.
    """
    complete_trials = []
    pruned_trials = []
    running_trials = []
    infeasible_trials = []

    for trial in trials:
        if trial.state == TrialState.RUNNING:
            running_trials.append(trial)
        elif constraints_enabled and _get_infeasible_trial_score(trial)[0]:
            infeasible_trials.append(trial)
        elif trial.state == TrialState.COMPLETE:
            complete_trials.append(trial)
        elif trial.state == TrialState.PRUNED:
            pruned_trials.append(trial)

    below_complete, above_complete = _split_complete_trials(complete_trials, study, n_below, device=device)
    n_below -= len(below_complete)
    below_pruned, above_pruned = _split_pruned_trials(pruned_trials, study, n_below)
    n_below -= len(below_pruned)
    below_infeasible, above_infeasible = _split_infeasible_trials(infeasible_trials, n_below)

    below_trials = below_complete + below_pruned + below_infeasible
    above_trials = above_complete + above_pruned + above_infeasible + running_trials
    below_trials.sort(key=lambda t: t.number)
    above_trials.sort(key=lambda t: t.number)
    return below_trials, above_trials


def _split_complete_trials(
    trials: list[FrozenTrial], study: "Study", n_below: int, *, device=None
) -> tuple[list[FrozenTrial], list[FrozenTrial]]:
    n_below = min(max(0, n_below), len(trials))
    if len(study.directions) <= 1:
        return _split_complete_trials_single_objective(trials, study, n_below)
    return _split_complete_trials_multi_objective(trials, study, n_below, device=device)


def _split_complete_trials_single_objective(
    trials: list[FrozenTrial], study: "Study", n_below: int
) -> tuple[list[FrozenTrial], list[FrozenTrial]]:
    if study.direction == StudyDirection.MINIMIZE:
        sorted_trials = sorted(trials, key=lambda t: t.value)  # type: ignore[arg-type,return-value]
    else:
        sorted_trials = sorted(trials, key=lambda t: t.value, reverse=True)  # type: ignore[arg-type,return-value]
    return sorted_trials[:n_below], sorted_trials[n_below:]


def _split_complete_trials_multi_objective(
    trials: list[FrozenTrial], study: "Study", n_below: int, *, device=None
) -> tuple[list[FrozenTrial], list[FrozenTrial]]:
    """MOTPE split: non-domination rank (through K2 on ``device`` from 512
    points), then HSSP inside the boundary rank (reference ``_split_trials``
    -> ``_solve_hssp``)."""
    if n_below == 0:
        return [], trials
    from optuna_tpu_torch.hypervolume import solve_hssp
    from optuna_tpu_torch.study._multi_objective import _fast_non_domination_rank, _normalize_values

    values = _normalize_values(np.asarray([t.values for t in trials], dtype=np.float64), study.directions)
    ranks = _fast_non_domination_rank(values, n_below=n_below, device=device)
    # Select whole ranks while they fit; the boundary rank is resolved by HSSP.
    unique_ranks = np.unique(ranks)
    below_idx: list[int] = []
    for r in unique_ranks:
        members = np.flatnonzero(ranks == r)
        if len(below_idx) + len(members) <= n_below:
            below_idx.extend(members.tolist())
            continue
        k = n_below - len(below_idx)
        if k > 0:
            rank_values = values[members]
            finite = values[np.all(np.isfinite(values), axis=1)]
            worst = np.max(finite, axis=0) if len(finite) else np.nanmax(rank_values, axis=0)
            ref_point = _hv_reference_point(worst)
            chosen = solve_hssp(rank_values, ref_point, k, device=device)
            below_idx.extend(members[chosen].tolist())
        break
    below_set = set(below_idx)
    below = [t for i, t in enumerate(trials) if i in below_set]
    above = [t for i, t in enumerate(trials) if i not in below_set]
    return below, above


def _split_pruned_trials(
    trials: list[FrozenTrial], study: "Study", n_below: int
) -> tuple[list[FrozenTrial], list[FrozenTrial]]:
    n_below = min(max(0, n_below), len(trials))
    # Multi-objective studies cannot report intermediate values, so ordering
    # by the first direction is only exercised in the single-objective case.
    sign = 1 if study.directions[0] == StudyDirection.MINIMIZE else -1

    def _key(t: FrozenTrial) -> tuple[float, float]:
        if len(t.intermediate_values) > 0:
            step = t.last_step
            assert step is not None
            value = t.intermediate_values[step]
            if math.isnan(value):
                return (-step, float("inf"))
            return (-step, sign * value)
        return (float("inf"), 0.0)

    sorted_trials = sorted(trials, key=_key)
    return sorted_trials[:n_below], sorted_trials[n_below:]


def _split_infeasible_trials(
    trials: list[FrozenTrial], n_below: int
) -> tuple[list[FrozenTrial], list[FrozenTrial]]:
    n_below = min(max(0, n_below), len(trials))
    sorted_trials = sorted(trials, key=lambda t: _get_infeasible_trial_score(t)[1])
    return sorted_trials[:n_below], sorted_trials[n_below:]


def _calculate_weights_below_for_multi_objective(
    study: "Study", below_trials: list[FrozenTrial], *, device=None
) -> np.ndarray | None:
    """Hypervolume-contribution weights for the below KDE (reference
    ``_calculate_weights_below_for_multi_objective:873``)."""
    if len(below_trials) <= 1:
        return None
    from optuna_tpu_torch.hypervolume import loo_contributions
    from optuna_tpu_torch.study._multi_objective import _normalize_values

    loss_vals = _normalize_values(
        np.asarray([t.values for t in below_trials], dtype=np.float64), study.directions
    )
    finite = np.all(np.isfinite(loss_vals), axis=1)
    if not np.any(finite):
        return None
    worst = np.max(loss_vals[finite], axis=0)
    ref_point = _hv_reference_point(worst)
    contributions = np.zeros(len(below_trials))
    finite_idx = np.flatnonzero(finite)
    # Routed exclusive contributions: 2D scan, WFG stack (M >= 5) on the
    # device at scale, host below.
    contributions[finite_idx] = loo_contributions(loss_vals[finite], ref_point, device=device)
    if contributions.sum() <= 0:
        return None
    weights = contributions + 1e-12
    return weights / weights.max()
