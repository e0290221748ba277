"""User-facing optimization session (PyTorch port of ``optuna_tpu/study/study.py``).

This carries ``create_study``, ``load_study``, ``delete_study``,
``copy_study``, ``get_all_study_names``, ``get_all_study_summaries``,
``Study.optimize`` (``n_jobs`` threads, the progress bar),
``ask/tell/add_trial(s)``, ``ask_batch`` (the host half of
``parallel.optimize_vectorized``), ``Study.optimize_scan``,
``trials_dataframe``, ``sampler_fallback=``, ``autopilot=``, the
observability exports (``telemetry_snapshot``, ``health_report``,
``trace_snapshot``), the ``best_*`` accessors and
``Study.optimize_sharded`` (the sharded tier over a ``DeviceMesh``).

Parity target: ``optuna/study/study.py`` (``Study:67``, ``create_study:1203``,
``load_study:1358``, ``delete_study:1447``, ``copy_study:1510``,
``get_all_study_summaries:1611``, WAITING->RUNNING CAS pop
``_pop_waiting_trial_id:1099``).
"""

from __future__ import annotations

import copy
import threading
from typing import TYPE_CHECKING, Any, Callable, Container, Iterable, Sequence, Union

from optuna_tpu_torch import exceptions, logging as logging_module
from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.study._multi_objective import _get_pareto_front_trials
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.study._study_summary import StudySummary
from optuna_tpu_torch.trial._frozen import FrozenTrial, create_trial
from optuna_tpu_torch.trial._state import TrialState
from optuna_tpu_torch.trial._trial import Trial

if TYPE_CHECKING:
    import pandas as pd

    from optuna_tpu_torch.pruners._base import BasePruner
    from optuna_tpu_torch.samplers._base import BaseSampler
    from optuna_tpu_torch.storages._base import BaseStorage

ObjectiveFuncType = Callable[[Trial], Union[float, Sequence[float]]]

_logger = logging_module.get_logger(__name__)

_SYSTEM_ATTR_METRIC_NAMES = "study:metric_names"


class _ThreadLocalStudyAttribute(threading.local):
    in_optimize_loop: bool = False
    cached_all_trials: list[FrozenTrial] | None = None


class Study:
    """A study = an optimization session over one objective (or objective vector)."""

    def __init__(
        self,
        study_name: str,
        storage: "str | BaseStorage",
        sampler: "BaseSampler | None" = None,
        pruner: "BasePruner | None" = None,
        *,
        sampler_fallback: str | None = None,
        autopilot: "str | Any | None" = None,
    ) -> None:
        from optuna_tpu_torch.pruners import MedianPruner
        from optuna_tpu_torch.storages import get_storage

        self.study_name = study_name
        storage = get_storage(storage)
        study_id = storage.get_study_id_from_name(study_name)
        self._study_id = study_id
        self._storage = storage
        self._directions = storage.get_study_directions(study_id)

        self.sampler = sampler or _default_sampler(self._directions)
        if sampler_fallback is not None:
            # Every suggestion this study asks for runs under GuardedSampler
            # containment: a sampler failure degrades per the policy instead
            # of aborting (a device fault still propagates; see
            # samplers/_resilience.py).
            from optuna_tpu_torch.samplers._resilience import GuardedSampler

            if not isinstance(self.sampler, GuardedSampler):
                self.sampler = GuardedSampler(self.sampler, fallback=sampler_fallback)
        self.pruner = pruner or MedianPruner()
        if autopilot is not None:
            # The doctor-driven control loop (optuna_tpu_torch.autopilot):
            # "observe" logs would-have-acted decisions, "act" executes them;
            # an AutopilotPolicy carries every knob. It attaches at each
            # optimize loop's entry.
            self._autopilot_request = autopilot

        self._thread_local = _ThreadLocalStudyAttribute()
        self._stop_flag = False

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        del state["_thread_local"]
        # The health reporter and the autopilot are per process (worker id,
        # baselines, locks); an unpickled study attaches fresh ones.
        state.pop("_health_reporter", None)
        state.pop("_autopilot", None)
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._thread_local = _ThreadLocalStudyAttribute()

    # ------------------------------------------------------------- properties

    @property
    def best_params(self) -> dict[str, Any]:
        return self.best_trial.params

    @property
    def best_value(self) -> float:
        best_value = self.best_trial.value
        assert best_value is not None
        return best_value

    @property
    def best_trial(self) -> FrozenTrial:
        if self._is_multi_objective():
            raise RuntimeError(
                "A single best trial cannot be retrieved from a multi-objective study. "
                "Consider using Study.best_trials to retrieve a list containing the best trials."
            )
        best_trial = self._storage.get_best_trial(self._study_id)
        # Filter infeasible trials if constraints (listed or named) are in play.
        from optuna_tpu_torch.study._constrained_optimization import (
            _get_feasible_trials,
            _is_feasible,
        )

        if not _is_feasible(best_trial.system_attrs):
            complete = self._get_trials(deepcopy=False, states=(TrialState.COMPLETE,))
            feasible = _get_feasible_trials(complete)
            if len(feasible) == 0:
                raise ValueError("No feasible trials are completed yet.")
            if self.direction == StudyDirection.MAXIMIZE:
                best_trial = max(feasible, key=lambda t: t.value)  # type: ignore[arg-type, return-value]
            else:
                best_trial = min(feasible, key=lambda t: t.value)  # type: ignore[arg-type, return-value]
        return copy.deepcopy(best_trial)

    @property
    def best_trials(self) -> list[FrozenTrial]:
        """Pareto-optimal (feasible) trials."""
        return _get_pareto_front_trials(self, consider_constraint=True)

    @property
    def direction(self) -> StudyDirection:
        if self._is_multi_objective():
            raise RuntimeError(
                "A single direction cannot be retrieved from a multi-objective study. "
                "Consider using Study.directions."
            )
        return self.directions[0]

    @property
    def directions(self) -> list[StudyDirection]:
        return self._directions

    @property
    def trials(self) -> list[FrozenTrial]:
        return self.get_trials(deepcopy=True)

    @property
    def user_attrs(self) -> dict[str, Any]:
        return copy.deepcopy(self._storage.get_study_user_attrs(self._study_id))

    @property
    def system_attrs(self) -> dict[str, Any]:
        return copy.deepcopy(self._storage.get_study_system_attrs(self._study_id))

    @property
    def metric_names(self) -> list[str] | None:
        return self._storage.get_study_system_attrs(self._study_id).get(
            _SYSTEM_ATTR_METRIC_NAMES
        )

    def _is_multi_objective(self) -> bool:
        return len(self._directions) > 1

    # ----------------------------------------------------------------- trials

    def get_trials(
        self,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        return self._get_trials(deepcopy=deepcopy, states=states, use_cache=False)

    def _get_trials(
        self,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
        use_cache: bool = False,
    ) -> list[FrozenTrial]:
        # Per-thread snapshot so one trial's many sampler reads hit storage once
        # (reference study.py:1687-1726 thread-local trial cache).
        if use_cache:
            if self._thread_local.cached_all_trials is None:
                self._thread_local.cached_all_trials = self._storage.get_all_trials(
                    self._study_id, deepcopy=False
                )
            trials = self._thread_local.cached_all_trials
            if states is not None:
                trials = [t for t in trials if t.state in states]
            return copy.deepcopy(trials) if deepcopy else trials
        return self._storage.get_all_trials(self._study_id, deepcopy=deepcopy, states=states)

    # --------------------------------------------------------------- optimize

    def optimize(
        self,
        func: ObjectiveFuncType,
        n_trials: int | None = None,
        timeout: float | None = None,
        n_jobs: int = 1,
        catch: Iterable[type[Exception]] | type[Exception] = (),
        callbacks: Sequence[Callable[["Study", FrozenTrial], None]] | None = None,
        gc_after_trial: bool = False,
        show_progress_bar: bool = False,
    ) -> None:
        """Run the ask -> objective -> tell loop (reference ``study.py:413``):
        ``n_jobs`` threads share one trial budget (``-1``: one per CPU), and
        ``show_progress_bar`` needs the optional ``tqdm``. Set
        ``OPTUNA_TPU_TORCH_TRACE=<logdir>`` to write a ``torch.profiler``
        trace of the whole run (see :mod:`optuna_tpu_torch._tracing`)."""
        from optuna_tpu_torch import _tracing
        from optuna_tpu_torch.study._optimize import _optimize

        with _tracing.maybe_trace_from_env():
            _optimize(
                study=self,
                func=func,
                n_trials=n_trials,
                timeout=timeout,
                n_jobs=n_jobs,
                catch=tuple(catch) if isinstance(catch, Iterable) else (catch,),
                callbacks=callbacks,
                gc_after_trial=gc_after_trial,
                show_progress_bar=show_progress_bar,
            )

    def optimize_scan(self, objective: Any, n_trials: int, **kwargs: Any) -> None:
        """Run ``n_trials`` GP-BO trials with the ask -> evaluate -> tell cycle
        on the device (see
        :func:`optuna_tpu_torch.parallel.scan_loop.optimize_scan`): history
        in power-of-two device buckets, ``sync_every`` trials per chunk with
        incremental Cholesky tells, storage synced once per chunk.
        ``objective`` is a
        :class:`~optuna_tpu_torch.parallel.vectorized.VectorizedObjective`;
        the study's sampler is bypassed."""
        from optuna_tpu_torch.parallel.scan_loop import optimize_scan

        optimize_scan(self, objective, n_trials, **kwargs)

    def optimize_sharded(self, objective: Any, n_trials: int, **kwargs: Any) -> None:
        """Run ``n_trials`` across a 2-D ``{'trials', 'model'}``
        ``DeviceMesh`` (see
        :func:`optuna_tpu_torch.parallel.sharded.optimize_sharded`): the
        trial batch shards along the ``trials`` axis, a
        :class:`~optuna_tpu_torch.parallel.sharded.ShardedObjective`'s model
        along its regex partition rules on the ``model`` axis, with the
        executor's containment operating per shard and trial sync between
        ranks riding the ICI journal's all-gather. On one rank it is trial
        for trial :func:`~optuna_tpu_torch.parallel.vectorized.
        optimize_vectorized` on the same seeded study."""
        from optuna_tpu_torch.parallel.sharded import optimize_sharded

        optimize_sharded(self, objective, n_trials, **kwargs)

    def ask(self, fixed_distributions: dict[str, BaseDistribution] | None = None) -> Trial:
        """Create a new (or claim a WAITING) trial (reference ``study.py:527``)."""
        if not self._thread_local.in_optimize_loop and is_heartbeat_enabled(self._storage):
            warnings.warn("Heartbeat of storage is supposed to be used with Study.optimize.")

        fixed_distributions = fixed_distributions or {}
        # Fresh per-ask trial cache: new trial => new history snapshot.
        self._thread_local.cached_all_trials = None

        trial_id = self._pop_waiting_trial_id()
        if trial_id is None:
            trial_id = self._storage.create_new_trial(self._study_id)
        return self._init_asked_trial(trial_id, fixed_distributions)

    def _init_asked_trial(
        self, trial_id: int, fixed_distributions: dict[str, BaseDistribution]
    ) -> Trial:
        """Per-trial setup for ask: fixed params, the
        ``before_trial`` hook, and the system-attr refresh."""
        trial = Trial(self, trial_id)
        for name, param in fixed_distributions.items():
            trial._suggest(name, param)

        self.sampler.before_trial(self, trial._cached_frozen_trial)
        # before_trial may have written trial system attrs through the storage
        # (e.g. GridSampler's grid id); refresh the cached snapshot so
        # subsequent suggest calls see them (the reference achieves the same
        # with its _LazyTrialSystemAttrs, ``_trial.py:822``). Skipped for
        # samplers that don't override the hook — no write can have happened.
        from optuna_tpu_torch.samplers._base import BaseSampler as _Base

        if type(self.sampler).before_trial is not _Base.before_trial:
            trial._cached_frozen_trial.system_attrs = self._storage.get_trial(
                trial._trial_id
            ).system_attrs
        return trial

    def ask_batch(
        self, n: int, fixed_distributions: dict[str, BaseDistribution] | None = None
    ) -> list[Trial]:
        """Create ``n`` trials in one storage batch, claiming WAITING trials
        first: the host half of vectorized optimization (reference
        ``optuna_tpu/study/study.py:319``).

        Semantically ``[study.ask() for _ in range(n)]``, but the fresh trials
        come from ``storage.create_new_trials``, so the batch costs one
        storage batch instead of n. An error while claiming, creating or
        initializing FAILs every trial already claimed or created (and fires
        the storage's failed-trial callback for each, so a claimed retry
        clone is enqueued again), then re-raises.
        """
        if not self._thread_local.in_optimize_loop and is_heartbeat_enabled(self._storage):
            warnings.warn("Heartbeat of storage is supposed to be used with Study.optimize.")

        fixed_distributions = fixed_distributions or {}
        self._thread_local.cached_all_trials = None

        trial_ids: list[int] = []
        try:
            while len(trial_ids) < n:
                waiting = self._pop_waiting_trial_id()
                if waiting is None:
                    break
                trial_ids.append(waiting)
            if len(trial_ids) < n:
                trial_ids.extend(self._storage.create_new_trials(self._study_id, n - len(trial_ids)))
            return [self._init_asked_trial(tid, fixed_distributions) for tid in trial_ids]
        except Exception as init_err:  # graphlint: ignore[PY001] -- containment boundary: every trial in trial_ids is already committed RUNNING, and an error during claim/create/init (sampler.before_trial, a storage blip) would otherwise strand them with no heartbeat recorded yet — unreapable by fail_stale_trials
            fail_and_notify_trials(
                self,
                trial_ids,
                reason=f"batch ask aborted: init raised {init_err!r}",
                best_effort=True,
            )
            raise

    def tell(
        self,
        trial: Trial | int,
        values: float | Sequence[float] | None = None,
        state: TrialState | None = None,
        skip_if_finished: bool = False,
    ) -> FrozenTrial:
        """Finish a trial created with ask (reference ``study.py:613``)."""
        from optuna_tpu_torch.study._tell import _tell_with_warning

        return _tell_with_warning(
            study=self,
            trial=trial,
            value_or_values=values,
            state=state,
            skip_if_finished=skip_if_finished,
        )

    # ------------------------------------------------------------------ attrs

    def set_user_attr(self, key: str, value: Any) -> None:
        self._storage.set_study_user_attr(self._study_id, key, value)

    def set_system_attr(self, key: str, value: Any) -> None:
        self._storage.set_study_system_attr(self._study_id, key, value)

    def set_metric_names(self, metric_names: list[str]) -> None:
        if len(self._directions) != len(metric_names):
            raise ValueError("The number of objectives must match the length of the metric names.")
        self._storage.set_study_system_attr(
            self._study_id, _SYSTEM_ATTR_METRIC_NAMES, metric_names
        )

    # ------------------------------------------------------------------- misc

    def trials_dataframe(
        self,
        attrs: tuple[str, ...] = (
            "number",
            "value",
            "datetime_start",
            "datetime_complete",
            "duration",
            "params",
            "user_attrs",
            "system_attrs",
            "state",
        ),
        multi_index: bool = False,
    ) -> "pd.DataFrame":
        """The trials as a ``pandas.DataFrame`` (``pandas`` is optional and
        imported here; without it this raises ``ImportError``, as the
        reference does)."""
        from optuna_tpu_torch.study._dataframe import _trials_dataframe

        return _trials_dataframe(self, attrs, multi_index)

    def telemetry_snapshot(self) -> dict[str, Any]:
        """The **process-local** telemetry snapshot (see
        :mod:`optuna_tpu_torch.telemetry`): phase histograms, the
        containment counters, the ``device.*`` gauges harvested from the
        device programs' stats, and under ``"jit"`` the per-label
        compile/retrace totals (:func:`optuna_tpu_torch.flight.jit_totals`).
        Enable recording with ``OPTUNA_TPU_TORCH_TELEMETRY=1`` or
        ``telemetry.enable()``; while disabled the counters, gauges and
        histograms are empty. The study-scoped sibling is
        :meth:`health_report`."""
        from optuna_tpu_torch import telemetry

        return telemetry.export_snapshot()

    def health_report(self, **kwargs: Any) -> dict[str, Any]:
        """The study doctor's **fleet-wide** report (see
        :mod:`optuna_tpu_torch.health`): every worker's published snapshot
        merged, per-worker liveness, and the findings with severities and
        remediation hints — what ``optuna-tpu-torch doctor`` and
        ``/health.json`` serve. Workers publish while the reporter is
        enabled (``OPTUNA_TPU_TORCH_HEALTH=1`` or ``health.enable()``); the
        trial-history checks run on any study."""
        from optuna_tpu_torch import health

        return health.report_for_study(self, **kwargs)

    def trace_snapshot(self) -> dict[str, Any]:
        """The flight recorder's timeline as Chrome trace-event JSON (load it
        in Perfetto or ``chrome://tracing``): per-trial ask/dispatch/tell
        spans, the scan loop's chunk and sync spans, containment and
        autopilot events, compile/retrace events and device gauges. Enable
        recording with ``OPTUNA_TPU_TORCH_FLIGHT=1`` or ``flight.enable()``.
        Samples the card's memory gauges once before exporting."""
        from optuna_tpu_torch import flight

        flight.sample_device_gauges()
        return flight.chrome_trace()

    def stop(self) -> None:
        """Request loop exit after the current trial (reference ``study.py:1033``)."""
        if not self._thread_local.in_optimize_loop:
            raise RuntimeError(
                "`Study.stop` is supposed to be invoked inside an objective function or a callback."
            )
        self._stop_flag = True

    def enqueue_trial(
        self,
        params: dict[str, Any],
        user_attrs: dict[str, Any] | None = None,
        skip_if_exists: bool = False,
    ) -> None:
        """Queue a WAITING trial with fixed params (reference ``study.py:938``)."""
        if skip_if_exists and self._should_skip_enqueue(params):
            _logger.info(f"Trial with params {params} already exists. Skipping enqueue.")
            return
        self.add_trial(
            create_trial(
                state=TrialState.WAITING,
                system_attrs={"fixed_params": params},
                user_attrs=user_attrs,
            )
        )

    def add_trial(self, trial: FrozenTrial) -> None:
        """Register an externally-created trial (reference ``study.py:830``)."""
        trial._validate()
        if trial.state.is_finished() and trial.values is not None:
            from optuna_tpu_torch.study._tell import _check_values_are_feasible

            message = _check_values_are_feasible(self, trial.values)
            if message is not None:
                raise ValueError(message)
        self._storage.create_new_trial(self._study_id, template_trial=trial)

    def add_trials(self, trials: Iterable[FrozenTrial]) -> None:
        for trial in trials:
            self.add_trial(trial)

    def _pop_waiting_trial_id(self) -> int | None:
        # Claim a WAITING trial through the storage CAS; this is the only
        # cross-worker synchronization point (reference study.py:1099-1118).
        for trial in self._storage.get_all_trials(
            self._study_id, deepcopy=False, states=(TrialState.WAITING,)
        ):
            if not self._storage.set_trial_state_values(
                trial._trial_id, state=TrialState.RUNNING
            ):
                continue
            _logger.info(f"Trial {trial.number} popped from the trial queue.")
            return trial._trial_id
        return None

    def _should_skip_enqueue(self, params: dict[str, Any]) -> bool:
        import math

        for trial in self._storage.get_all_trials(self._study_id, deepcopy=False):
            trial_params = trial.system_attrs.get("fixed_params", trial.params)
            if trial_params.keys() != params.keys():
                continue

            def _match(a: Any, b: Any) -> bool:
                try:
                    a_f, b_f = float(a), float(b)
                    return (math.isnan(a_f) and math.isnan(b_f)) or a_f == b_f
                except (TypeError, ValueError):
                    return a == b

            if all(_match(trial_params[k], params[k]) for k in params):
                return True
        return False

    def _log_completed_trial(self, trial: FrozenTrial) -> None:
        if not _logger.isEnabledFor(logging_module.INFO):
            return
        if len(trial.values) > 1:
            _logger.info(
                f"Trial {trial.number} finished with values: {trial.values} "
                f"and parameters: {trial.params}."
            )
        elif len(trial.values) == 1:
            best_trial = None
            try:
                best_trial = self.best_trial
            except ValueError:
                pass
            _logger.info(
                f"Trial {trial.number} finished with value: {trial.values[0]} and parameters: "
                f"{trial.params}. Best is trial "
                f"{best_trial.number if best_trial else trial.number} "
                f"with value: {best_trial.value if best_trial else trial.values[0]}."
            )
        else:
            raise AssertionError


def _default_sampler(directions: list[StudyDirection]) -> "BaseSampler":
    """TPE for one objective, NSGA-II for several, as in the reference
    (``optuna_tpu/study/study.py:574-584``). TPE's device is the card,
    resolved at its first ask."""
    if len(directions) > 1:
        from optuna_tpu_torch.samplers import NSGAIISampler

        return NSGAIISampler()
    from optuna_tpu_torch.samplers import TPESampler

    return TPESampler()


# ---------------------------------------------------------------------- module


def create_study(
    *,
    storage: "str | BaseStorage | None" = None,
    sampler: "BaseSampler | None" = None,
    pruner: "BasePruner | None" = None,
    study_name: str | None = None,
    direction: str | StudyDirection | None = None,
    load_if_exists: bool = False,
    directions: Sequence[str | StudyDirection] | None = None,
    sampler_fallback: str | None = None,
) -> Study:
    """Create (or load, with ``load_if_exists``) a study (reference ``study.py:1203``)."""
    from optuna_tpu_torch.storages import get_storage

    if direction is None and directions is None:
        directions = ["minimize"]
    elif direction is not None and directions is not None:
        raise ValueError("Specify only one of `direction` and `directions`.")
    elif direction is not None:
        directions = [direction]
    assert directions is not None

    if len(directions) < 1:
        raise ValueError("The number of objectives must be greater than 0.")
    direction_objects = []
    for d in directions:
        if isinstance(d, str):
            if d.lower() not in ("minimize", "maximize"):
                raise ValueError(f"Please set either 'minimize' or 'maximize' to direction. Got {d}.")
            direction_objects.append(
                StudyDirection.MINIMIZE if d.lower() == "minimize" else StudyDirection.MAXIMIZE
            )
        elif isinstance(d, StudyDirection):
            direction_objects.append(d)
        else:
            raise ValueError(f"Please set either 'minimize' or 'maximize' to direction. Got {d}.")

    storage_obj = get_storage(storage)
    try:
        study_id = storage_obj.create_new_study(direction_objects, study_name)
    except exceptions.DuplicatedStudyError:
        if load_if_exists:
            assert study_name is not None
            _logger.info(
                f"Using an existing study with name '{study_name}' instead of creating a new one."
            )
            study_id = storage_obj.get_study_id_from_name(study_name)
        else:
            raise

    study_name = storage_obj.get_study_name_from_id(study_id)
    return Study(
        study_name=study_name,
        storage=storage_obj,
        sampler=sampler,
        pruner=pruner,
        sampler_fallback=sampler_fallback,
    )


def load_study(
    *,
    study_name: str | None = None,
    storage: "str | BaseStorage",
    sampler: "BaseSampler | None" = None,
    pruner: "BasePruner | None" = None,
    sampler_fallback: str | None = None,
) -> Study:
    """Load an existing study (reference ``study.py:1358``)."""
    from optuna_tpu_torch.storages import get_storage

    storage_obj = get_storage(storage)
    if study_name is None:
        studies = storage_obj.get_all_studies()
        if len(studies) != 1:
            raise ValueError(
                f"Could not determine the study name since the storage "
                f"{storage} does not contain exactly 1 study. Specify `study_name`."
            )
        study_name = studies[0].study_name
    return Study(
        study_name=study_name,
        storage=storage_obj,
        sampler=sampler,
        pruner=pruner,
        sampler_fallback=sampler_fallback,
    )


def delete_study(*, study_name: str, storage: "str | BaseStorage") -> None:
    from optuna_tpu_torch.storages import get_storage

    storage_obj = get_storage(storage)
    study_id = storage_obj.get_study_id_from_name(study_name)
    storage_obj.delete_study(study_id)


def copy_study(
    *,
    from_study_name: str,
    from_storage: "str | BaseStorage",
    to_storage: "str | BaseStorage",
    to_study_name: str | None = None,
) -> None:
    """Copy a study across storages (reference ``study.py:1510``)."""
    from_study = load_study(study_name=from_study_name, storage=from_storage)
    to_study = create_study(
        study_name=to_study_name or from_study_name,
        storage=to_storage,
        directions=from_study.directions,
        load_if_exists=False,
    )
    for key, value in from_study.system_attrs.items():
        to_study.set_system_attr(key, value)
    for key, value in from_study.user_attrs.items():
        to_study.set_user_attr(key, value)
    to_study.add_trials(from_study.get_trials())


def get_all_study_names(storage: "str | BaseStorage") -> list[str]:
    from optuna_tpu_torch.storages import get_storage

    return [s.study_name for s in get_storage(storage).get_all_studies()]


def get_all_study_summaries(
    storage: "str | BaseStorage", include_best_trial: bool = True
) -> list[StudySummary]:
    """Summaries of every study in the storage (reference ``study.py:1611``)."""
    from optuna_tpu_torch.storages import get_storage

    storage_obj = get_storage(storage)
    summaries = []
    for frozen_study in storage_obj.get_all_studies():
        study_id = frozen_study._study_id
        trials = storage_obj.get_all_trials(study_id, deepcopy=False)
        best_trial: FrozenTrial | None = None
        if include_best_trial and len(frozen_study.directions) == 1:
            try:
                best_trial = storage_obj.get_best_trial(study_id)
            except ValueError:
                pass
        datetime_start = min(
            (t.datetime_start for t in trials if t.datetime_start is not None), default=None
        )
        summaries.append(
            StudySummary(
                study_name=frozen_study.study_name,
                direction=None,
                directions=frozen_study.directions,
                best_trial=best_trial,
                user_attrs=frozen_study.user_attrs,
                system_attrs=frozen_study.system_attrs,
                n_trials=len(trials),
                datetime_start=datetime_start,
                study_id=study_id,
            )
        )
    return summaries


# Imports placed at the tail to break the storages<->study cycle.
import warnings  # noqa: E402

from optuna_tpu_torch.storages._heartbeat import fail_and_notify_trials, is_heartbeat_enabled  # noqa: E402
