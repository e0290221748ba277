"""Gaussian-process Bayesian-optimization sampler (PyTorch port of
``optuna_tpu/samplers/_gp/sampler.py``).

This slice carries the single-objective, unconstrained path
(``_sample_fused``): the exact engine (:func:`~optuna_tpu_torch.gp.fused.
gp_suggest_fused`) up to ``n_exact_max`` trials, the SGPR engine
(:func:`~optuna_tpu_torch.gp.sparse.gp_suggest_sparse_fused`) above it,
the per-space device constants and the kernel-parameter warm-start cache.
The speculative chain, the AOT precompile pool, constraints, running-trial
QLogEI, multi-objective EHVI and ``sample_relative_batch`` are not ported
yet and raise where the reference would take them.

Numerics run on ``device`` (``cuda`` unless ``device="cpu"``) in f32; host
standardization stays in f64. The reference draws the candidate shift and
the start-selection noise from ``jax.random``; here they come from a
``torch.Generator`` seeded with the same per-ask seed the reference keys
its PRNG with.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Mapping, Sequence

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler
from optuna_tpu_torch.search_space import IntersectionSearchSpace
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_N_INCUMBENTS = 4


class GPSampler(BaseSampler):
    """GP-BO with Matern-5/2 ARD kernels, MAP-fitted by batched L-BFGS on the device."""

    def __init__(
        self,
        *,
        seed: int | None = None,
        independent_sampler: BaseSampler | None = None,
        n_startup_trials: int = 10,
        deterministic_objective: bool = False,
        n_preliminary_samples: int = 2048,
        n_local_search: int = 10,
        n_exact_max: int | None = None,
        n_inducing: int | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        self._device = resolve_device(device)
        self._rng = LazyRandomState(seed)
        self._independent_sampler = independent_sampler or RandomSampler(seed=seed)
        self._n_startup_trials = n_startup_trials
        self._deterministic = deterministic_objective
        self._n_preliminary_samples = n_preliminary_samples
        self._n_local_search = n_local_search
        self._intersection_search_space = IntersectionSearchSpace()
        # Warm-start cache: search-space signature -> raw log kernel params.
        self._kernel_params_cache: dict[tuple, list[np.ndarray]] = {}
        # Device-resident per-space constants (Sobol pool, bounds, sweep
        # tables) so per-trial host->device traffic is just history + starts.
        self._device_space_cache: dict[tuple, "_DeviceSpace"] = {}
        # Large-n switch: histories past `n_exact_max` (default
        # gp.sparse.N_EXACT_MAX) take the SGPR engine with up to
        # `n_inducing` inducing points.
        self._n_exact_max = n_exact_max
        self._n_inducing = n_inducing

    def reseed_rng(self) -> None:
        self._rng.seed()
        self._independent_sampler.reseed_rng()

    # -------------------------------------------- fitted-state checkpoints

    def export_fitted_state(self) -> "dict[str, Any] | None":
        """The kernel-param warm-start cache, keyed by search-space
        signature; None while nothing has been fitted."""
        if not self._kernel_params_cache:
            return None
        return {
            "kernel_params_cache": {
                sig: [np.asarray(p) for p in params]
                for sig, params in self._kernel_params_cache.items()
            },
        }

    def restore_fitted_state(self, state: "Mapping[str, Any]") -> bool:
        """Warm-load an exported kernel-param cache (True iff anything was
        accepted). Existing entries win."""
        cache = state.get("kernel_params_cache") if isinstance(state, Mapping) else None
        if not isinstance(cache, dict) or not cache:
            return False
        for sig, params in cache.items():
            self._kernel_params_cache.setdefault(
                tuple(sig), [np.asarray(p) for p in params]
            )
        return True

    # ------------------------------------------------------- large-n switch

    def _sparse_limits(self) -> tuple[int, int]:
        """The resolved (exact-size threshold, inducing capacity)."""
        from optuna_tpu_torch.gp.sparse import N_EXACT_MAX, N_INDUCING_MAX

        limit = N_EXACT_MAX if self._n_exact_max is None else int(self._n_exact_max)
        m = N_INDUCING_MAX if self._n_inducing is None else int(self._n_inducing)
        return max(1, limit), max(1, m)

    # ----------------------------------------------------------- search space

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        search_space = {}
        for name, distribution in self._intersection_search_space.calculate(study).items():
            if distribution.single():
                continue
            search_space[name] = distribution
        return search_space

    # --------------------------------------------------------------- sampling

    def sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        if search_space == {}:
            return {}

        states = (TrialState.COMPLETE,)
        trials = study._get_trials(deepcopy=False, states=states, use_cache=True)
        trials = [t for t in trials if all(p in t.params for p in search_space)]
        if len(trials) < self._n_startup_trials:
            return {}

        if len(study.directions) != 1:
            raise NotImplementedError(
                "optuna_tpu_torch's GPSampler is single-objective so far "
                "(LogEHVI comes with ROADMAP.md item A6)."
            )
        if self._has_other_running_trials(study, search_space, trial):
            raise NotImplementedError(
                "optuna_tpu_torch's GPSampler does not fantasize running trials yet "
                "(the reference's QLogEI path); tell pending trials before asking."
            )
        from optuna_tpu_torch.gp.search_space import SearchSpace

        space = SearchSpace(search_space)
        X = space.normalize([t.params for t in trials]).astype(np.float32)
        seed = int(self._rng.rng.randint(0, 2**31 - 1))
        sig = self._space_signature(search_space)
        warm = self._kernel_params_cache.get(sig)
        return self._sample_fused(study, space, X, trials, warm, sig, seed)

    # --------------------------------------------------------- fused dispatch

    # Fit budgets: cold multi-start when no warm kernel params exist for the
    # space; a short 2-start refinement (default + previous optimum) once
    # they do.
    _COLD_FIT = (4, 60)
    _WARM_FIT = (2, 24)

    def _device_space(self, sig: tuple, space) -> "_DeviceSpace":
        # This cache and ``_kernel_params_cache`` are unlocked on purpose:
        # asks from ``n_jobs`` threads may both miss and build; each value is
        # complete before it is stored, so a race costs one extra build (or
        # keeps the other thread's warm start), never a wrong answer.
        dev = self._device_space_cache.get(sig)
        if dev is None:
            dev = _DeviceSpace(space, self._n_preliminary_samples, self._device)
            self._device_space_cache[sig] = dev
        return dev

    def _fused_inputs(self, study, X, trials, warm):
        """Host-side packing of the fused programs' history inputs."""
        from optuna_tpu_torch.gp.gp import _bucket
        from optuna_tpu_torch.samplers._resilience import collapse_duplicate_rows

        rng = self._rng.rng
        d = X.shape[1]
        raw_vals = np.asarray([t.value for t in trials], dtype=np.float64)
        score = raw_vals if study.direction == StudyDirection.MAXIMIZE else -raw_vals
        y, _, _ = _standardize(score)

        # Exact-duplicate design rows collapse to one row whose mask carries
        # the observation count; duplicate-free histories pass unchanged.
        X, y, counts = collapse_duplicate_rows(X, y)
        n = X.shape[0]

        N = _bucket(n)
        Xp = np.zeros((N, d), dtype=np.float32)
        Xp[:n] = X
        yp = np.zeros(N, dtype=np.float32)
        yp[:n] = y
        maskp = np.zeros(N, dtype=np.float32)
        maskp[:n] = counts

        default = np.zeros(d + 2, dtype=np.float32)
        default[d + 1] = np.log(1e-2)
        if warm is not None and len(warm):
            n_starts, fit_iters = self._WARM_FIT
            starts = [default, np.asarray(warm[0], dtype=np.float32)][:n_starts]
        else:
            n_starts, fit_iters = self._COLD_FIT
            starts = [default]
        while len(starts) < n_starts:
            starts.append((default + rng.normal(0, 1.0, size=d + 2)).astype(np.float32))

        # Fixed-shape incumbent block: the most recent observations join the
        # candidate pool so local search can start from near the frontier.
        inc = X[-min(n, _N_INCUMBENTS):]
        if len(inc) < _N_INCUMBENTS:
            inc = np.concatenate([np.repeat(inc[:1], _N_INCUMBENTS - len(inc), axis=0), inc])

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32).to(self._device)

        return up(np.stack(starts)), up(Xp), up(yp), up(maskp), up(inc), n, fit_iters

    def _draws(self, seed: int, n_candidates: int, d: int):
        """(shift (d,), gumbel (n_candidates,)) from a generator seeded with
        the ask's seed: the stand-in for the reference's PRNG key."""
        from optuna_tpu_torch.gp.fused import gumbel_noise

        gen = torch.Generator(device=self._device)
        gen.manual_seed(seed)
        shift = torch.rand(d, generator=gen, device=self._device, dtype=torch.float32)
        return shift, gumbel_noise(n_candidates, gen, self._device)

    def _sample_fused(self, study, space, X, trials, warm, sig, seed):
        """Single-objective unconstrained suggestion: exact or sparse engine."""
        from optuna_tpu_torch.gp.optim_mixed import snap_steps

        dev = self._device_space(sig, space)
        starts, Xp, yp, maskp, inc, n, fit_iters = self._fused_inputs(study, X, trials, warm)
        minimum_noise = 1e-7 if self._deterministic else 1e-5
        shift, gumbel = self._draws(seed, inc.shape[0] + dev.sobol_base.shape[0], X.shape[1])
        common = (
            dev.cont_mask, dev.lower, dev.upper, dev.n_choices, dev.steps,
            dev.dim_onehot, dev.choice_grid, dev.choice_valid,
        )
        n_exact_max, _ = self._sparse_limits()
        if n > n_exact_max:
            args = (
                starts, Xp, yp, dev.cat_mask, maskp, dev.sobol_base, inc,
                shift[None], gumbel[None], minimum_noise, *common,
            )
            xs, _vs, raw, _stats = self._sparse_call(args, n, fit_iters=fit_iters, dev=dev)
            x_best = xs[0]
        else:
            from optuna_tpu_torch.gp.fused import gp_suggest_fused

            x_best, _, raw, _stats = gp_suggest_fused(
                starts, Xp, yp, dev.cat_mask, maskp, dev.sobol_base, inc,
                shift, gumbel, minimum_noise, *common,
                n_local_search=self._n_local_search,
                fit_iters=fit_iters,
                has_sweep=dev.has_sweep,
            )
        self._kernel_params_cache[sig] = [raw.detach().cpu().numpy()]
        # Snap stepped dims (the fused program treats them as continuous).
        x_np = snap_steps(space, x_best.detach().cpu().numpy().astype(np.float64))
        return space.unnormalize_one(x_np)

    def _sparse_call(self, args, n: int, *, fit_iters: int, dev):
        """Run the SGPR program (one proposal) for a history of ``n`` real
        rows: the inducing capacity is the configured cap, power-of-two padded."""
        from optuna_tpu_torch.gp.sparse import _pow2_bucket, gp_suggest_sparse_fused

        _, m_cap = self._sparse_limits()
        m_pad = _pow2_bucket(max(1, min(m_cap, n)))
        return gp_suggest_sparse_fused(
            *args,
            q=1,
            m_pad=m_pad,
            n_local_search=self._n_local_search,
            fit_iters=fit_iters,
            has_sweep=dev.has_sweep,
        )

    # ----------------------------------------------------------------- helpers

    @staticmethod
    def _has_other_running_trials(
        study: "Study", search_space: dict[str, BaseDistribution], current: FrozenTrial
    ) -> bool:
        return any(
            t.number != current.number and all(p in t.params for p in search_space)
            for t in study._get_trials(deepcopy=False, states=(TrialState.RUNNING,), use_cache=True)
        )

    @staticmethod
    def _space_signature(search_space: dict[str, BaseDistribution]) -> tuple:
        return tuple((name, repr(dist)) for name, dist in search_space.items())

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        return self._independent_sampler.sample_independent(
            study, trial, param_name, param_distribution
        )

    def before_trial(self, study: "Study", trial: FrozenTrial) -> None:
        self._independent_sampler.before_trial(study, trial)

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        self._independent_sampler.after_trial(study, trial, state, values)


class _DeviceSpace:
    """Per-search-space constants resident on the device across trials.

    The candidate pool is SciPy's scrambled Sobol (seed 0), made on the host
    and uploaded once: the reference's fallback for its device Sobol, whose
    ``jax.random`` digital shift PyTorch cannot reproduce."""

    def __init__(self, space, n_preliminary: int, device: torch.device) -> None:
        from optuna_tpu_torch.gp.optim_mixed import _sweep_tables, continuous_bounds
        from optuna_tpu_torch.ops.qmc import sobol_sample

        def up(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

        d = space.dim
        self.sobol_base = up(sobol_sample(n_preliminary, d, seed=0))
        self.cat_mask = up(np.asarray(space.is_categorical).astype(bool), torch.bool)
        cont_mask, lower, upper = continuous_bounds(space)
        self.cont_mask = up(cont_mask)
        self.lower = up(lower)
        self.upper = up(upper)
        self.n_choices = up(space.n_choices.astype(np.float32))
        self.steps = up(space.steps.astype(np.float32))
        tables = _sweep_tables(space)
        self.has_sweep = tables is not None
        if tables is None:
            onehot = np.zeros((1, d))
            grid = np.zeros((1, 1))
            valid = np.zeros((1, 1), dtype=bool)
        else:
            onehot, grid, valid = tables
        self.dim_onehot = up(onehot)
        self.choice_grid = up(grid)
        self.choice_valid = up(valid, torch.bool)


def _standardize(values: np.ndarray) -> tuple[np.ndarray, float, float]:
    """f64 host z-scoring with ±inf clipped to the float32 extremes first."""
    from optuna_tpu_torch.samplers._resilience import clip_objective_values

    values = clip_objective_values(values)
    mu = float(np.mean(values))
    sd = float(np.std(values))
    if sd <= 1e-12 or not np.isfinite(sd):
        sd = 1.0
    return ((values - mu) / sd), mu, sd
