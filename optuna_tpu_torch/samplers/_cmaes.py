"""CMA-ES sampler with storage-externalized state (port of
``optuna_tpu/samplers/_cmaes.py``).

Parity target: ``optuna/samplers/_cmaes.py:50`` (``CmaEsSampler``): optimizer
state serialized into system attrs in <=2045-char hex chunks and restored
every trial, so the sampler is stateless across processes; solutions are
generation-tagged; each completed generation triggers a ``tell``.

The optimizer itself is :mod:`optuna_tpu_torch.ops.cmaes` — ask/tell in
torch with ``eigh`` on ``device`` (``None``: the card, resolved at the first
relative ask; ``"cpu"`` to run on the CPU). The state stays on the device
between generations; the per-trial path is host work on the queue, and a
generation costs one host read of the packed state and queue (plus what
``eigh`` forces). The ask's normals come from
:func:`optuna_tpu_torch.ops.cmaes.ask_draws`, seeded by the reference's
fold-in pair. Supports full-covariance and separable (``use_separable_cma``)
modes plus ``x0``/``sigma0`` warm starts.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.distributions import BaseDistribution, CategoricalDistribution
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler
from optuna_tpu_torch.search_space import IntersectionSearchSpace
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.transform import SearchSpaceTransform
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)

_GENERATION_KEY = "cma:generation"
_RUN_KEY = "cma:run"  # increments on IPOP/BIPOP restarts
_X_KEY = "cma:x"
_STATE_KEY_PREFIX = "cma:state"
_MAX_CHUNK = 2045  # mirrors the reference's RDB varchar-safe chunking


class CmaEsSampler(BaseSampler):
    def __init__(
        self,
        x0: dict[str, Any] | None = None,
        sigma0: float | None = None,
        n_startup_trials: int = 1,
        independent_sampler: BaseSampler | None = None,
        warn_independent_sampling: bool = True,
        seed: int | None = None,
        *,
        consider_pruned_trials: bool = False,
        restart_strategy: str | None = None,
        popsize: int | None = None,
        inc_popsize: int = 2,
        use_separable_cma: bool = False,
        with_margin: bool = False,
        lr_adapt: bool = False,
        device: "str | torch.device | None" = None,
    ) -> None:
        self._x0 = x0
        self._sigma0 = sigma0
        self._n_startup_trials = n_startup_trials
        self._independent_sampler = independent_sampler or RandomSampler(seed=seed)
        self._warn_independent_sampling = warn_independent_sampling
        self._rng = LazyRandomState(seed)
        self._search_space = IntersectionSearchSpace()
        self._consider_pruned_trials = consider_pruned_trials
        self._restart_strategy = restart_strategy
        self._popsize = popsize
        self._inc_popsize = inc_popsize
        self._use_separable_cma = use_separable_cma
        self._with_margin = with_margin
        self._lr_adapt = lr_adapt
        self._device_arg = device
        self._device: torch.device | None = None
        if restart_strategy is not None and restart_strategy not in ("ipop", "bipop"):
            raise ValueError("restart_strategy must be one of 'ipop', 'bipop' or None.")

    @property
    def device(self) -> torch.device:
        """Where the optimizer state lives; resolved at first use, so a
        sampler built without a card raises at its first relative ask."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    def reseed_rng(self) -> None:
        self._rng.seed()
        self._independent_sampler.reseed_rng()

    def _seed_value(self) -> int:
        if not hasattr(self, "_derived_seed"):
            self._derived_seed = int(self._rng.rng.randint(0, 2**31 - 1))
        return self._derived_seed

    # ----------------------------------------------------------- search space

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        search_space: dict[str, BaseDistribution] = {}
        for name, distribution in self._search_space.calculate(study).items():
            if distribution.single():
                continue
            if isinstance(distribution, CategoricalDistribution):
                # CMA-ES is a continuous optimizer (reference skips these too).
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
        self._raise_error_if_multi_objective(study)
        if len(search_space) == 0:
            return {}
        if len(search_space) == 1:
            _logger.info(
                "CMA-ES does not support one-dimensional spaces; falling back "
                "to the independent sampler."
            )
            return {}

        from optuna_tpu_torch.ops import cmaes as cma_ops

        completed = self._completed_trials(study)
        if len(completed) < self._n_startup_trials:
            return {}

        trans = SearchSpaceTransform(search_space, transform_0_1=True)
        dim = len(trans.bounds)
        sigma0 = self._sigma0 or 0.3  # [0,1]-normalized space
        steps = self._normalized_steps(trans, search_space) if self._with_margin else None

        dev = self.device
        restored = self._restore_state(study)
        if restored is not None and (
            restored[0].mean.shape[0] != dim or restored[1]["queue"].shape[1] != dim
        ):
            # Dynamic define-by-run space changed dimensionality: the stored
            # optimizer no longer matches (reference _cmaes.py:414 guard).
            _logger.warning(
                "The CMA-ES optimizer dimension no longer matches the search "
                "space; restarting the optimizer."
            )
            restored = None
        if restored is None:
            popsize = self._popsize or cma_ops.default_popsize(dim)
            mean0 = self._initial_mean(trans, search_space)
            state = cma_ops.cma_init(
                mean0, sigma0, popsize=popsize, sep=self._use_separable_cma, device=dev
            )
            if steps is not None:
                state = cma_ops.apply_margin(state, steps, self._margin_alpha(dim, popsize))
            z = cma_ops.ask_draws(self._seed_value(), 0, popsize, dim, dev)
            host, (queue,) = cma_ops.to_host(state, cma_ops.cma_ask(state, z))
            queue = queue.astype(np.float64)
            extra = {
                "queue": queue,
                "run": np.asarray(0),
                "popsize": np.asarray(popsize),
                "n_restarts": np.asarray(0),
                "n_large": np.asarray(0),
                "budget_large": np.asarray(0),
                "budget_small": np.asarray(0),
                "evals_run": np.asarray(0),
                "best_hist": np.zeros(0),
                "regime": np.asarray(0),  # 0 = large (the initial run), 1 = small
            }
            self._store_state(study, state, extra, host)
        else:
            state, extra = restored
        popsize = int(np.asarray(extra["popsize"]))
        run = int(np.asarray(extra["run"]))
        queue = np.asarray(extra["queue"], dtype=np.float64)

        # Tell when the current generation has a full set of completed
        # solutions; the plain config fuses tell+ask into one call with one
        # host read per generation (margin/restart checks add host-side work
        # only on generation boundaries; the per-trial path below is pure
        # host work: the generation is read from the host extras).
        gen = int(np.asarray(extra["generation"]))
        gen_trials = [
            t
            for t in completed
            if t.system_attrs.get(_GENERATION_KEY) == gen
            and t.system_attrs.get(_RUN_KEY, 0) == run
            and _X_KEY in t.system_attrs
            # After a dimension-change restart, the old optimizer's trials of
            # the same generation and run are not this one's.
            and len(t.system_attrs[_X_KEY]) == dim
            and t.values is not None  # pruned trials without reports carry no value
        ]
        if len(gen_trials) >= popsize:
            gen_trials = gen_trials[:popsize]
            X = np.asarray([t.system_attrs[_X_KEY] for t in gen_trials], dtype=np.float32)
            sign = 1.0 if study.direction == StudyDirection.MINIMIZE else -1.0
            fitness = np.asarray([sign * t.value for t in gen_trials], dtype=np.float32)
            fold = (run << 16) ^ (gen + 1)
            X_t, fitness_t = cma_ops.upload_population(X, fitness, dev)
            # Keep enough history for every termination criterion: the
            # stagnation test needs 120 + 30*d generations plus its 20-gen
            # comparison windows.
            hist_cap = 120 + 30 * dim + 60
            extra["best_hist"] = np.append(
                np.asarray(extra["best_hist"], dtype=np.float64), float(fitness.min())
            )[-hist_cap:]
            extra["evals_run"] = np.asarray(int(np.asarray(extra["evals_run"])) + popsize)

            needs_host_state = (
                steps is not None or self._restart_strategy is not None
            )
            if not needs_host_state:
                z = cma_ops.ask_draws(self._seed_value(), fold, popsize, dim, dev)
                state, queue_t = cma_ops.cma_tell_and_ask(
                    state, X_t, fitness_t, z, lr_adapt=self._lr_adapt
                )
            else:
                state = cma_ops.cma_tell(state, X_t, fitness_t, lr_adapt=self._lr_adapt)
                stop = (
                    cma_ops.should_stop(
                        state, fitness, np.asarray(extra["best_hist"]), sigma0
                    )
                    if self._restart_strategy is not None
                    else None
                )
                if stop is not None:
                    state, extra, popsize = self._restarted(extra, sigma0, stop, dim)
                    run = int(np.asarray(extra["run"]))
                if steps is not None:
                    state = cma_ops.apply_margin(
                        state, steps, self._margin_alpha(dim, popsize)
                    )
                z = cma_ops.ask_draws(self._seed_value(), fold, popsize, dim, dev)
                queue_t = cma_ops.cma_ask(state, z)
            # The generation's one host read: the state and the queue, packed.
            host, (queue,) = cma_ops.to_host(state, queue_t)
            queue = queue.astype(np.float64)
            extra["queue"] = queue
            self._store_state(study, state, extra, host)
            gen = int(host.generation)

        # Pop the next queued solution: index = how many trials this
        # generation already claimed (completed or running).
        all_trials = study._get_trials(deepcopy=False, use_cache=True)
        n_claimed = sum(
            1
            for t in all_trials
            if t.system_attrs.get(_GENERATION_KEY) == gen
            and t.system_attrs.get(_RUN_KEY, 0) == run
        )
        x = queue[n_claimed % popsize]

        study._storage.set_trial_system_attr(trial._trial_id, _GENERATION_KEY, gen)
        if run:
            study._storage.set_trial_system_attr(trial._trial_id, _RUN_KEY, run)
        study._storage.set_trial_system_attr(trial._trial_id, _X_KEY, x.tolist())
        return trans.untransform(x)

    # ------------------------------------------------------- restarts / margin

    @staticmethod
    def _margin_alpha(dim: int, popsize: int) -> float:
        # CMAwM's default margin: 1 / (d * lambda).
        return 1.0 / max(dim * popsize, 1)

    @staticmethod
    def _normalized_steps(
        trans: SearchSpaceTransform, search_space: dict[str, BaseDistribution]
    ) -> np.ndarray | None:
        """Per-encoded-dim grid step in the [0,1] space (0 = continuous)."""
        steps = []
        for dist in search_space.values():
            step = getattr(dist, "step", None)
            if step:
                low, high = float(dist.low), float(dist.high)
                # The transform widens discrete bounds by half a step.
                steps.append(step / max(high - low + step, 1e-12))
            else:
                steps.append(0.0)
        arr = np.asarray(steps, dtype=np.float64)
        return arr if np.any(arr > 0) else None

    def _restarted(self, extra, sigma0, reason, dim):
        """Build a fresh optimizer per the IPOP/BIPOP schedule (reference
        ``_cmaes.py:507-589``: IPOP multiplies popsize by ``inc_popsize``
        each restart; BIPOP alternates large and budget-matched small
        regimes)."""
        from optuna_tpu_torch.ops import cmaes as cma_ops

        default = cma_ops.default_popsize(dim)
        n_restarts = int(np.asarray(extra["n_restarts"])) + 1
        n_large = int(np.asarray(extra["n_large"]))
        budget_large = int(np.asarray(extra["budget_large"]))
        budget_small = int(np.asarray(extra["budget_small"]))
        evals_run = int(np.asarray(extra["evals_run"]))
        prev_popsize = int(np.asarray(extra["popsize"]))

        prev_regime = int(np.asarray(extra.get("regime", 0)))

        rng = self._rng.rng
        new_regime = 0
        if self._restart_strategy == "ipop":
            popsize = prev_popsize * self._inc_popsize
            n_large += 1
            budget_large += evals_run
        else:  # bipop
            # Attribute the finished run's evals to its *recorded* regime —
            # a small-regime draw can exceed the default popsize, so the
            # regime cannot be inferred from the popsize.
            if prev_regime == 0:
                budget_large += evals_run
            else:
                budget_small += evals_run
            if budget_small < budget_large:
                new_regime = 1
                ratio = 0.5 * self._inc_popsize ** n_large
                popsize = max(
                    2, int(default * ratio ** (rng.uniform() ** 2))
                )
            else:
                n_large += 1
                popsize = default * self._inc_popsize ** n_large
        _logger.info(
            f"CMA-ES restart #{n_restarts} ({self._restart_strategy}, reason="
            f"{reason}): popsize {prev_popsize} -> {popsize}."
        )
        mean0 = rng.uniform(0.0, 1.0, size=dim)
        state = cma_ops.cma_init(
            mean0, sigma0, popsize=popsize, sep=self._use_separable_cma, device=self.device
        )
        extra.update(
            run=np.asarray(int(np.asarray(extra["run"])) + 1),
            popsize=np.asarray(popsize),
            n_restarts=np.asarray(n_restarts),
            n_large=np.asarray(n_large),
            budget_large=np.asarray(budget_large),
            budget_small=np.asarray(budget_small),
            evals_run=np.asarray(0),
            best_hist=np.zeros(0),
            regime=np.asarray(new_regime),
        )
        return state, extra, popsize

    def _initial_mean(
        self, trans: SearchSpaceTransform, search_space: dict[str, BaseDistribution]
    ) -> np.ndarray:
        if self._x0 is None:
            return np.full(len(trans.bounds), 0.5)
        return trans.transform({**{k: v for k, v in self._x0.items()}})

    def _completed_trials(self, study: "Study") -> list[FrozenTrial]:
        states = [TrialState.COMPLETE]
        if self._consider_pruned_trials:
            states.append(TrialState.PRUNED)
        return study._get_trials(deepcopy=False, states=tuple(states), use_cache=True)

    # ----------------------------------------------------------- state attrs

    def _attr_key(self) -> str:
        variant = "sep" if self._use_separable_cma else "full"
        return f"{_STATE_KEY_PREFIX}:{variant}"

    def _store_state(self, study: "Study", state, extra: dict[str, np.ndarray], host) -> None:
        """Write ``state`` (on the device) through its host copy ``host``;
        the generation is kept in the host extras too, so the per-trial path
        reads no tensor."""
        from optuna_tpu_torch.ops.cmaes import state_to_bytes

        extra["generation"] = np.asarray(int(host.generation))
        payload = state_to_bytes(host, extra=extra)
        hexstr = payload.hex()
        chunks = [hexstr[i : i + _MAX_CHUNK] for i in range(0, len(hexstr), _MAX_CHUNK)]
        key = self._attr_key()
        # Version-stamped double buffer: chunks land under slot ver=gen%2 and
        # only then does the head pointer flip, so a concurrent reader either
        # sees the previous complete version or the new one — never a mix.
        ver = int(host.generation) % 2
        for i, chunk in enumerate(chunks):
            study._storage.set_study_system_attr(study._study_id, f"{key}:{ver}:{i}", chunk)
        study._storage.set_study_system_attr(
            study._study_id, f"{key}:head", {"ver": ver, "n": len(chunks)}
        )
        self._state_cache = (hexstr, (state, extra))

    def _restore_state(self, study: "Study"):
        from optuna_tpu_torch.ops.cmaes import state_from_bytes

        attrs = study._storage.get_study_system_attrs(study._study_id)
        key = self._attr_key()
        head = attrs.get(f"{key}:head")
        if head is None:
            return None
        try:
            hexstr = "".join(attrs[f"{key}:{head['ver']}:{i}"] for i in range(head["n"]))
            cached = getattr(self, "_state_cache", None)
            if cached is not None and cached[0] == hexstr:
                return cached[1]
            state, extra = state_from_bytes(bytes.fromhex(hexstr), device=self.device)
            result = (state, extra)
            self._state_cache = (hexstr, result)
            return result
        except Exception:  # graphlint: ignore[PY001] -- corrupt/racing state attrs of any flavor -> clean optimizer restart is always safe
            _logger.warning("Broken CMA-ES state attrs; restarting the optimizer.")
            return None

    # ------------------------------------------------------------ independent

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        completed = self._completed_trials(study)
        if len(completed) >= self._n_startup_trials and self._warn_independent_sampling:
            _logger.warning(
                f"The parameter '{param_name}' in trial#{trial.number} is sampled "
                "independently by using `{}` instead of `CmaEsSampler`.".format(
                    self._independent_sampler.__class__.__name__
                )
            )
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
