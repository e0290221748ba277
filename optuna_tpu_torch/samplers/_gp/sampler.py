"""Gaussian-process Bayesian-optimization sampler (PyTorch port of
``optuna_tpu/samplers/_gp/sampler.py``).

Routes, chosen per ask as the reference chooses them:

* single-objective, unconstrained, no running trials: the fused engines,
  exact (:func:`~optuna_tpu_torch.gp.fused.gp_suggest_fused`) up to
  ``n_exact_max`` trials and SGPR
  (:func:`~optuna_tpu_torch.gp.sparse.gp_suggest_sparse_fused`) above it;
  with ``speculative_chain=q`` a kriging-believer chain of q proposals
  (:func:`~optuna_tpu_torch.gp.fused.gp_suggest_chain_fused` or the sparse
  twin) serves q sequential asks from a queue;
* otherwise the host path: :func:`~optuna_tpu_torch.gp.gp.fit_gp` (its
  sparse twin above the threshold, K1 on the card), an acquisition (LogEI,
  qLogEI over QMC fantasies of running trials, LogEHVI on several
  objectives, each optionally times the constraints' feasibility), and
  :func:`~optuna_tpu_torch.gp.optim_mixed.optimize_acqf_mixed`.

Numerics run on ``device`` (``cuda`` unless ``device="cpu"``) in f32; host
standardization stays in f64. The reference draws the fused programs'
candidate shift and start-selection noise from ``jax.random``; here they
come from a ``torch.Generator`` seeded with the same per-ask seed the
reference keys its PRNG with. The host path's draws (the candidate pool,
the roulette, the QMC fantasies) are host NumPy/SciPy, as the reference's.
The reference's ahead-of-bucket AOT compile pool has no counterpart in
eager PyTorch: ``precompile_ahead`` is accepted and has no effect.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

import numpy as np
import torch

from optuna_tpu_torch import _tracing, device_stats, flight, telemetry
from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.samplers._base import BaseSampler, _process_constraints_after_trial
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler
from optuna_tpu_torch.search_space import IntersectionSearchSpace
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_N_INCUMBENTS = 4
_N_FANTASIES = 128
_MAX_RUNNING = 8  # fantasized running trials, the most recent first kept
_STABILIZING_NOISE = 1e-10

# The ask-phase split (telemetry.PHASES): search-space build, surrogate fit
# (or the fused programs' host packing) and proposal.
_TRACE_SPACE = telemetry.trace_name("ask.search_space")
_TRACE_FIT = telemetry.trace_name("ask.fit")
_TRACE_PROPOSE = telemetry.trace_name("ask.propose")


class GPSampler(BaseSampler):
    """GP-BO with Matern-5/2 ARD kernels, MAP-fitted by batched L-BFGS on the device."""

    def __init__(
        self,
        *,
        seed: int | None = None,
        independent_sampler: BaseSampler | None = None,
        n_startup_trials: int = 10,
        deterministic_objective: bool = False,
        constraints_func: Callable[[FrozenTrial], Sequence[float]] | None = None,
        n_preliminary_samples: int = 2048,
        n_local_search: int = 10,
        speculative_chain: int = 0,
        precompile_ahead: bool = True,
        n_exact_max: int | None = None,
        n_inducing: int | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        self._device = resolve_device(device)
        self._rng = LazyRandomState(seed)
        self._independent_sampler = independent_sampler or RandomSampler(seed=seed)
        self._n_startup_trials = n_startup_trials
        self._deterministic = deterministic_objective
        self._constraints_func = constraints_func
        self._n_preliminary_samples = n_preliminary_samples
        self._n_local_search = n_local_search
        self._intersection_search_space = IntersectionSearchSpace()
        # Warm-start cache: search-space signature -> raw log kernel params
        # (one per objective on the LogEHVI route).
        self._kernel_params_cache: dict[tuple, list[np.ndarray]] = {}
        # Device-resident per-space constants (Sobol pool, bounds, sweep
        # tables) so per-trial host->device traffic is just history + starts.
        self._device_space_cache: dict[tuple, "_DeviceSpace"] = {}
        # Speculative ask-ahead: > 1 turns sequential asks into
        # kriging-believer chains of that depth, one dispatch for
        # `speculative_chain` trials. The queue is keyed by (study, space
        # signature) and the completed count it expects next; its lock keeps
        # two `n_jobs` threads from popping one entry twice.
        self._spec_chain = int(speculative_chain)
        self._spec_queue: list[dict[str, Any]] = []
        self._spec_sig: tuple | None = None
        self._spec_expected_n = -1
        self._spec_lock = threading.Lock()
        # ``precompile_ahead`` is accepted for the reference's signature and
        # not stored: eager PyTorch has no ahead-of-time compile to hand off.
        # Large-n switch: histories past `n_exact_max` (default
        # gp.sparse.N_EXACT_MAX) take the SGPR engine with up to
        # `n_inducing` inducing points. None defers to the module defaults
        # at each use.
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

    def autopilot_densify(self):
        """Autopilot actuator (``gp.densify``): widen the sparse engine one
        notch — double the inducing capacity up to
        :data:`~optuna_tpu_torch.gp.sparse.N_INDUCING_MAX`, then (at cap)
        raise the exact-size threshold out of reach so later fits take the
        exact posterior. Returns the undo restoring the previous knobs."""
        from optuna_tpu_torch.gp.sparse import N_INDUCING_MAX

        previous = (self._n_exact_max, self._n_inducing)
        _, m = self._sparse_limits()
        if m < N_INDUCING_MAX:
            self._n_inducing = min(2 * m, N_INDUCING_MAX)
        else:
            self._n_exact_max = 10**9

        def undo() -> None:
            self._n_exact_max, self._n_inducing = previous

        return undo

    # ----------------------------------------------------------- search space

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        with _tracing.annotate(_TRACE_SPACE), telemetry.span("ask.search_space"), flight.span("ask.search_space"):
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

        return self._sample_relative_impl(study, trial, search_space, trials)

    def _sample_relative_impl(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
        trials: list[FrozenTrial],
    ) -> dict[str, Any]:
        from optuna_tpu_torch.gp.acqf import LogEIData
        from optuna_tpu_torch.gp.gp import fit_gp
        from optuna_tpu_torch.gp.optim_mixed import optimize_acqf_mixed
        from optuna_tpu_torch.gp.search_space import SearchSpace

        space = SearchSpace(search_space)
        X = space.normalize([t.params for t in trials]).astype(np.float32)
        is_cat = np.asarray(space.is_categorical)
        rng = self._rng.rng
        seed = int(rng.randint(0, 2**31 - 1))

        n_objectives = len(study.directions)
        sig = self._space_signature(search_space)
        warm = self._kernel_params_cache.get(sig)

        running = (
            self._running_trials_matrix(study, space, search_space, trial)
            if n_objectives == 1
            else None
        )
        if n_objectives == 1 and self._constraints_func is None and running is None:
            if self._spec_chain > 1:
                return self._sample_speculative(study, space, X, trials, warm, sig, seed)
            return self._sample_fused(study, space, X, trials, warm, sig, seed)

        cat_mask = torch.as_tensor(is_cat.astype(bool)).to(self._device)
        if n_objectives == 1:
            # Internal convention: maximize the standardized score.
            from optuna_tpu_torch.samplers._resilience import collapse_duplicate_rows

            raw_vals = np.asarray([t.value for t in trials], dtype=np.float64)
            score = raw_vals if study.direction == StudyDirection.MAXIMIZE else -raw_vals
            y, _, _ = _standardize(score)
            Xc, yc, counts = collapse_duplicate_rows(X, y)
            with _tracing.annotate(_TRACE_FIT), telemetry.span("ask.fit"), flight.span("ask.fit"):
                state, raw_params, fit_stats = fit_gp(
                    Xc,
                    yc.astype(np.float32),
                    is_cat,
                    warm_start_raw=warm[0] if warm else None,
                    seed=seed,
                    minimum_noise=1e-7 if self._deterministic else 1e-5,
                    counts=counts,
                    n_exact_max=self._n_exact_max,
                    n_inducing=self._n_inducing,
                    device=self._device,
                )
            if device_stats.enabled():
                # The sparse fit reports its inducing stats; the exact fit
                # reports none.
                inducing = {k: fit_stats[k] for k in ("gp.inducing_count", "gp.sparsity_ratio") if k in fit_stats}
                if inducing:
                    device_stats.harvest(inducing, trial=trial.number)
            ladder_rungs = [fit_stats["gp.ladder_rung"]]
            self._kernel_params_cache[sig] = [raw_params]
            best = float(np.max(yc))
            if running is not None:
                acqf_name, data = self._build_qlogei(state, cat_mask, running, best, seed)
            else:
                acqf_name = "logei"
                data = LogEIData(
                    state=state,
                    cat_mask=cat_mask,
                    best=self._scalar(best),
                    stabilizing_noise=self._scalar(_STABILIZING_NOISE),
                )
        else:
            acqf_name, data, raws, ladder_rungs = self._build_logehvi(
                study, trials, X, is_cat, cat_mask, warm, seed
            )
            self._kernel_params_cache[sig] = raws

        if self._constraints_func is not None:
            acqf_name, data, cons_rungs = self._wrap_constraints(
                acqf_name, data, trials, X, is_cat, cat_mask, seed
            )
            ladder_rungs = ladder_rungs + cons_rungs

        extra = X[-min(len(X), _N_INCUMBENTS):]  # warm-start local search at recent incumbents
        with _tracing.annotate(_TRACE_PROPOSE), telemetry.span("ask.propose"), flight.span("ask.propose"):
            x_best, _ = optimize_acqf_mixed(
                acqf_name,
                data,
                space,
                rng,
                extra_candidates=extra,
                n_preliminary=self._n_preliminary_samples,
                n_local_search=self._n_local_search,
            )
        # Host boundary: x_best is on the host, so the fits are long done and
        # reading their rungs waits for nothing.
        if device_stats.enabled():
            device_stats.harvest({"gp.ladder_rung": max(int(r) for r in ladder_rungs)}, trial=trial.number)
        return space.unnormalize_one(x_best)

    def _scalar(self, value: float) -> torch.Tensor:
        return torch.tensor(value, dtype=torch.float32, device=self._device)

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

    def _fused_inputs(self, study, X, trials, warm, pad_extra: int = 0):
        """Host-side packing of the fused programs' history inputs; the
        chain asks for ``pad_extra = q`` free slots past the history."""
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

        N = _bucket(n + pad_extra)
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

    def _draws(self, seed: int, n_candidates: int, d: int, q: int = 1):
        """(shifts (q, d), gumbels (q, n_candidates)) from a generator seeded
        with the ask's seed, a round at a time (a shift, then its Gumbel
        noise): the stand-in for the reference's ``fold_in(key, i)``."""
        from optuna_tpu_torch.gp.fused import gumbel_noise

        gen = torch.Generator(device=self._device)
        gen.manual_seed(seed)
        shifts, gumbels = [], []
        for _ in range(q):
            shifts.append(torch.rand(d, generator=gen, device=self._device, dtype=torch.float32))
            gumbels.append(gumbel_noise(n_candidates, gen, self._device))
        return torch.stack(shifts), torch.stack(gumbels)

    def _fused_args(self, study, space, X, trials, warm, sig, seed, q: int, pad_extra: int = 0):
        """Everything the fused programs take: the packed history, the
        space's device constants and the ask's draws for ``q`` rounds."""
        dev = self._device_space(sig, space)
        starts, Xp, yp, maskp, inc, n, fit_iters = self._fused_inputs(
            study, X, trials, warm, pad_extra=pad_extra
        )
        shifts, gumbels = self._draws(seed, inc.shape[0] + dev.sobol_base.shape[0], X.shape[1], q)
        common = (
            dev.cont_mask, dev.lower, dev.upper, dev.n_choices, dev.steps,
            dev.dim_onehot, dev.choice_grid, dev.choice_valid,
        )
        return dev, (starts, Xp, yp, maskp, inc), shifts, gumbels, common, n, fit_iters

    def _sample_fused(self, study, space, X, trials, warm, sig, seed):
        """Single-objective unconstrained suggestion: exact or sparse engine."""
        from optuna_tpu_torch.gp.optim_mixed import snap_steps

        # The wall-clock split: "ask.fit" is the host packing of the fit's
        # inputs, "ask.propose" the one device program that fits and
        # proposes; its stats struct says what it spent its work on.
        with _tracing.annotate(_TRACE_FIT), telemetry.span("ask.fit"), flight.span("ask.fit"):
            dev, (starts, Xp, yp, maskp, inc), shifts, gumbels, common, n, fit_iters = self._fused_args(
                study, space, X, trials, warm, sig, seed, q=1
            )
        minimum_noise = 1e-7 if self._deterministic else 1e-5
        n_exact_max, _ = self._sparse_limits()
        with _tracing.annotate(_TRACE_PROPOSE), telemetry.span("ask.propose"), flight.span("ask.propose"):
            if n > n_exact_max:
                args = (
                    starts, Xp, yp, dev.cat_mask, maskp, dev.sobol_base, inc,
                    shifts, gumbels, minimum_noise, *common,
                )
                xs, _vs, raw, dev_stats = self._sparse_call(args, n, q=1, fit_iters=fit_iters, dev=dev)
                x_best = xs[0]
            else:
                from optuna_tpu_torch.gp.fused import gp_suggest_fused

                x_best, _, raw, dev_stats = gp_suggest_fused(
                    starts, Xp, yp, dev.cat_mask, maskp, dev.sobol_base, inc,
                    shifts[0], gumbels[0], minimum_noise, *common,
                    n_local_search=self._n_local_search,
                    fit_iters=fit_iters,
                    has_sweep=dev.has_sweep,
                )
            self._kernel_params_cache[sig] = [raw.detach().cpu().numpy()]
        # Host boundary: raw was just read, so the program is done and the
        # stats' reads wait for nothing.
        device_stats.harvest(dev_stats)
        # Snap stepped dims (the fused program treats them as continuous).
        x_np = snap_steps(space, x_best.detach().cpu().numpy().astype(np.float64))
        return space.unnormalize_one(x_np)

    def _sparse_call(self, args, n: int, *, q: int, fit_iters: int, dev):
        """Run the SGPR program (q proposals) for a history of ``n`` real
        rows: the inducing capacity is the configured cap, power-of-two
        padded; a chain searches from fewer starts."""
        from optuna_tpu_torch.gp.sparse import _pow2_bucket, gp_suggest_sparse_fused

        _, m_cap = self._sparse_limits()
        m_pad = _pow2_bucket(max(1, min(m_cap, n)))
        n_local = self._n_local_search if q == 1 else min(self._n_local_search, 6)
        return gp_suggest_sparse_fused(
            *args,
            q=q,
            m_pad=m_pad,
            n_local_search=n_local,
            fit_iters=fit_iters,
            has_sweep=dev.has_sweep,
        )

    def _sample_speculative(self, study, space, X, trials, warm, sig, seed):
        """Serve from (or refill) the speculative chain, so q sequential asks
        cost one dispatch. The queue is keyed by (study, space signature,
        completed count): a sampler shared across studies never
        cross-serves, and a trial that did not complete invalidates it."""
        n = len(trials)
        spec_key = (study._study_id,) + sig
        with self._spec_lock:
            if self._spec_queue and self._spec_sig == spec_key and n == self._spec_expected_n:
                self._spec_expected_n += 1
                return self._spec_queue.pop(0)
        proposals = self._sample_chain(study, space, X, trials, warm, sig, seed, q=self._spec_chain)
        with self._spec_lock:
            self._spec_queue = proposals[1:]
            self._spec_sig = spec_key
            self._spec_expected_n = n + 1
        return proposals[0]

    def _sample_chain(self, study, space, X, trials, warm, sig, seed, q) -> list[dict[str, Any]]:
        """q kriging-believer proposals from one dispatch (exact chain or
        the sparse program's, above the threshold)."""
        from optuna_tpu_torch.gp.fused import gp_suggest_chain_fused
        from optuna_tpu_torch.gp.optim_mixed import snap_steps

        with _tracing.annotate(_TRACE_FIT), telemetry.span("ask.fit"), flight.span("ask.fit"):
            dev, (starts, Xp, yp, maskp, inc), shifts, gumbels, common, n, fit_iters = self._fused_args(
                study, space, X, trials, warm, sig, seed, q=q, pad_extra=q
            )
        minimum_noise = 1e-7 if self._deterministic else 1e-5
        n_exact_max, _ = self._sparse_limits()
        with _tracing.annotate(_TRACE_PROPOSE), telemetry.span("ask.propose"), flight.span("ask.propose"):
            if n > n_exact_max:
                # The sparse program's chain tells each fantasy by an O(m^2)
                # additive factor raise instead of an O(n^2) row append.
                args = (
                    starts, Xp, yp, dev.cat_mask, maskp, dev.sobol_base, inc,
                    shifts, gumbels, minimum_noise, *common,
                )
                xs, _vs, raw, dev_stats = self._sparse_call(args, n, q=q, fit_iters=fit_iters, dev=dev)
            else:
                xs, _vs, raw, dev_stats = gp_suggest_chain_fused(
                    starts, Xp, yp, dev.cat_mask, maskp, n, dev.sobol_base, inc,
                    shifts, gumbels, minimum_noise, *common,
                    q=q,
                    n_local_search=min(self._n_local_search, 6),
                    fit_iters=fit_iters,
                    has_sweep=dev.has_sweep,
                )
            self._kernel_params_cache[sig] = [raw.detach().cpu().numpy()]
        device_stats.harvest(dev_stats)
        xs_np = xs.detach().cpu().numpy().astype(np.float64)
        return [space.unnormalize_one(snap_steps(space, xs_np[i])) for i in range(len(xs_np))]

    def sample_relative_batch(
        self,
        study: "Study",
        search_space: dict[str, BaseDistribution],
        batch_size: int,
    ) -> list[dict[str, Any]]:
        """Batched ask: q joint proposals from one chain dispatch; empty
        dicts before startup, on several objectives or with constraints."""
        if not search_space:
            return [{} for _ in range(batch_size)]
        trials = study._get_trials(deepcopy=False, states=(TrialState.COMPLETE,), use_cache=True)
        trials = [t for t in trials if all(p in t.params for p in search_space)]
        if (
            len(trials) < self._n_startup_trials
            or len(study.directions) != 1
            or self._constraints_func is not None
        ):
            return [{} for _ in range(batch_size)]

        from optuna_tpu_torch.gp.search_space import SearchSpace

        space = SearchSpace(search_space)
        X = space.normalize([t.params for t in trials]).astype(np.float32)
        sig = self._space_signature(search_space)
        warm = self._kernel_params_cache.get(sig)
        seed = int(self._rng.rng.randint(0, 2**31 - 1))
        return self._sample_chain(study, space, X, trials, warm, sig, seed, q=batch_size)

    # ------------------------------------------------------------ acqf builds

    def _build_qlogei(self, state, cat_mask, running_X: np.ndarray, best: float, seed: int):
        """Fantasize the running trials and average LogEI over the fantasies.

        Above the exact threshold ``state`` is the reduced m-point state (its
        X the inducing set), extended as it stands, as the reference does.
        The reference's ``vmap(cho_solve)`` over the F fantasies is one
        ``cholesky_solve`` with an (N + R, F) right-hand side."""
        from optuna_tpu_torch.gp.acqf import QLogEIData
        from optuna_tpu_torch.gp.gp import GPState, _kernel_with_noise, matern52, upload
        from optuna_tpu_torch.ops.qmc import normal_qmc_sample
        from optuna_tpu_torch.samplers._resilience import ladder_cholesky

        with torch.no_grad():
            X_obs, mask = state.X, state.mask
            R = running_X.shape[0]
            Xr = upload(running_X, self._device)

            # Joint posterior at the running points.
            k_or = matern52(X_obs, Xr, state.params, cat_mask)  # (N, R)
            k_rr = matern52(Xr, Xr, state.params, cat_mask)  # (R, R)
            v = torch.linalg.solve_triangular(state.L, k_or, upper=False)  # (N, R)
            mean_r = k_or.T @ state.alpha
            eye = torch.eye(R, dtype=torch.float32, device=self._device)
            # Jitter ladder: two running trials at identical params (retry
            # clones in flight) make cov_r exactly singular.
            L_r = ladder_cholesky(k_rr - v.T @ v + eye * 1e-5)
            z = upload(normal_qmc_sample(_N_FANTASIES, R, seed=seed), self._device)
            y_f = mean_r[None, :] + z @ L_r.T  # (F, R)

            # Extended GP over [X_obs; X_r]: one shared Cholesky, F alphas.
            N = X_obs.shape[0]
            X_ext = torch.cat([X_obs, Xr], dim=0)
            mask_ext = torch.cat([mask, torch.ones(R, dtype=mask.dtype, device=self._device)])
            L_ext = ladder_cholesky(_kernel_with_noise(X_ext, state.params, cat_mask, mask_ext))
            y_ext = torch.cat([state.y.expand(_N_FANTASIES, N), y_f], dim=1)  # (F, N + R)
            alphas = torch.cholesky_solve(y_ext.T, L_ext).T
            best_f = torch.maximum(self._scalar(best), torch.max(y_f, dim=1).values)
            zeros = torch.zeros(N + R, dtype=torch.float32, device=self._device)
        ext_state = GPState(params=state.params, X=X_ext, y=zeros, mask=mask_ext, L=L_ext, alpha=zeros)
        data = QLogEIData(
            state=ext_state,
            cat_mask=cat_mask,
            alphas=alphas,
            best=best_f,
            stabilizing_noise=self._scalar(_STABILIZING_NOISE),
        )
        return "qlogei", data

    def _build_logehvi(self, study, trials, X, is_cat, cat_mask, warm, seed):
        """One GP per objective (``seed + k``, warm from the k-th cached raw
        where there is one), LogEHVI over the box decomposition of the
        standardized losses."""
        from optuna_tpu_torch.gp.acqf import LogEHVIData
        from optuna_tpu_torch.gp.box_decomposition import nondominated_box_decomposition
        from optuna_tpu_torch.gp.gp import fit_gp, stack_states, upload
        from optuna_tpu_torch.ops.qmc import normal_qmc_sample
        from optuna_tpu_torch.study._multi_objective import _normalize_values

        # Minimization convention for the EHVI plane.
        loss_vals = _normalize_values(
            np.asarray([t.values for t in trials], dtype=np.float64), study.directions
        )
        M = loss_vals.shape[1]
        states, raws, rungs = [], [], []
        std_vals = np.empty_like(loss_vals, dtype=np.float32)
        for k in range(M):
            yk, _, _ = _standardize(loss_vals[:, k])
            std_vals[:, k] = yk
            with _tracing.annotate(_TRACE_FIT), telemetry.span("ask.fit"), flight.span("ask.fit"):
                st, raw, fit_stats = fit_gp(
                    X,
                    yk.astype(np.float32),
                    is_cat,
                    warm_start_raw=warm[k] if warm and len(warm) > k else None,
                    seed=seed + k,
                    device=self._device,
                )
            states.append(st)
            raws.append(raw)
            rungs.append(fit_stats["gp.ladder_rung"])

        worst = np.max(std_vals, axis=0)
        ref_point = np.maximum(worst * 1.1, worst * 0.9) + 1e-6
        lowers, uppers = nondominated_box_decomposition(std_vals.astype(np.float64), ref_point)
        qmc_z = normal_qmc_sample(_N_FANTASIES, M, seed=seed)

        data = LogEHVIData(
            states=stack_states(states),
            cat_mask=cat_mask,
            box_lowers=upload(lowers, self._device),
            box_uppers=upload(uppers, self._device),
            qmc_z=upload(qmc_z, self._device),
            stabilizing_noise=self._scalar(_STABILIZING_NOISE),
        )
        return "logehvi", data, raws, rungs

    def _wrap_constraints(self, acqf_name, data, trials, X, is_cat, cat_mask, seed):
        """One GP per constraint (``seed + 101 + k``) on its standardized
        values; the acquisition gains their log-feasibility at threshold
        ``(0 - mu) / sd``. Unchanged while a trial lacks its constraints."""
        from optuna_tpu_torch.gp.acqf import ConstrainedData
        from optuna_tpu_torch.gp.gp import fit_gp, stack_states, upload
        from optuna_tpu_torch.study._constrained_optimization import _constraints_list

        constraint_rows = [_constraints_list(t.system_attrs) for t in trials]
        if any(c is None for c in constraint_rows):
            return acqf_name, data, []
        cons = np.asarray(constraint_rows, dtype=np.float64)  # (n, C)
        states, thresholds, rungs = [], [], []
        for k in range(cons.shape[1]):
            yk, mu, sd = _standardize(cons[:, k])
            with _tracing.annotate(_TRACE_FIT), telemetry.span("ask.fit"), flight.span("ask.fit"):
                st, _, fit_stats = fit_gp(
                    X, yk.astype(np.float32), is_cat, seed=seed + 101 + k, device=self._device
                )
            states.append(st)
            thresholds.append((0.0 - mu) / sd)
            rungs.append(fit_stats["gp.ladder_rung"])
        return f"constrained_{acqf_name}", ConstrainedData(
            base=data,
            constraint_states=stack_states(states),
            constraint_cat_mask=cat_mask,
            constraint_thresholds=upload(thresholds, self._device),
            stabilizing_noise=self._scalar(_STABILIZING_NOISE),
        ), rungs

    # ----------------------------------------------------------------- helpers

    def _running_trials_matrix(
        self,
        study: "Study",
        space,
        search_space: dict[str, BaseDistribution],
        current: FrozenTrial,
    ) -> np.ndarray | None:
        """The normalized params of the other RUNNING trials that carry the
        whole space (the last ``_MAX_RUNNING``), None when there are none."""
        running = [
            t
            for t in study._get_trials(deepcopy=False, states=(TrialState.RUNNING,), use_cache=True)
            if t.number != current.number and all(p in t.params for p in search_space)
        ]
        if not running:
            return None
        running = running[-_MAX_RUNNING:]  # cap fantasized trials to bound the work
        return space.normalize([t.params for t in running]).astype(np.float32)

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
        if self._constraints_func is not None:
            _process_constraints_after_trial(self._constraints_func, study, trial, state)
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
