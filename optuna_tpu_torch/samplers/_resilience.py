"""Numerical guards of the sampler path (port of the in-graph ring and the
host conditioners of ``optuna_tpu/samplers/_resilience.py``).

* :func:`ladder_cholesky_with_rung` — Cholesky with escalating diagonal
  jitter; the single Cholesky call site for sampler code.
* :func:`ladder_cholesky_rank1_update` — append one observation's row to a
  ladder factor in O(n²), with a full-refactorization fallback.
* :func:`ladder_cholesky_rank1_raise` — additive rank-1 update of a ladder
  factor with a full-refactorization fallback.
* :func:`clip_objective_values`, :func:`collapse_duplicate_rows` — host-side
  degenerate-history conditioners applied before standardization.

* :class:`GuardedSampler` — the containment wrapper: a sampler exception,
  a non-finite proposal or an overrun fit deadline degrades one trial to
  independent sampling (``fallback='independent'``) or re-raises after
  recording (``'raise'``), with ``sampler_fallback:`` trial attrs. Unlike
  the reference it never contains a device fault (:func:`is_device_fault`).

The reference runs its ladders as ``lax.while_loop``/``lax.cond`` with the
health verdict on the device. Here each verdict is read to the host once per
call (one sync per ladder), and the loops are Python loops.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

import numpy as np
import torch

from optuna_tpu_torch import flight, telemetry
from optuna_tpu_torch.distributions import BaseDistribution, CategoricalDistribution
from optuna_tpu_torch.logging import get_logger, warn_once
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)

_F32_MAX = float(np.finfo(np.float32).max)

#: Jitter ladder: multiples of the Gram diagonal scale tried in order until
#: the factor is good. The first rung (0) is the bare matrix — the happy
#: path costs exactly one factorization.
_LADDER_INITIAL_JITTER = 1e-6
_LADDER_GROWTH = 100.0
_LADDER_MAX_RUNGS = 4


def _factor(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, ok): ``torch.linalg.cholesky_ex`` can hand back a finite but wrong
    partial factor with ``info > 0`` where JAX returns NaN, so a factor is
    good only when ``info == 0`` *and* every entry is finite."""
    L, info = torch.linalg.cholesky_ex(K)
    return L, (info == 0) & torch.all(torch.isfinite(L))


def ladder_cholesky_with_rung(
    K: torch.Tensor, *, initial_jitter: float = _LADDER_INITIAL_JITTER
) -> tuple[torch.Tensor, int]:
    """Factor ``K`` as-is, and while the factor is bad escalate additive
    diagonal jitter (``initial_jitter · 100^rung`` of the diagonal scale) and
    refactor, at most ``_LADDER_MAX_RUNGS`` times. Returns ``(L, rung)``:
    ``rung`` counts the escalation refactorizations, 0 when the bare matrix
    factored. If every rung fails, ``L`` is NaN, as the reference's is.
    2-D matrices only."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    # Jitter scales with the matrix, floored at 1.0 so an all-zero Gram
    # (possible when every row collapsed to the origin) still regularizes.
    scale = torch.clamp(torch.max(torch.abs(torch.diagonal(K))), min=1.0)
    L, ok = _factor(K)
    rung = 0
    while rung < _LADDER_MAX_RUNGS and not bool(ok):
        jitter = initial_jitter * (_LADDER_GROWTH**rung) * scale
        L, ok = _factor(K + eye * jitter)
        rung += 1
    if not bool(ok):
        L = torch.full_like(L, float("nan"))
    return L, rung


def ladder_cholesky(K: torch.Tensor, *, initial_jitter: float = _LADDER_INITIAL_JITTER):
    """:func:`ladder_cholesky_with_rung` without the rung."""
    L, _ = ladder_cholesky_with_rung(K, initial_jitter=initial_jitter)
    return L


#: Relative pivot floor for the incremental update: below this fraction of
#: the new row's own diagonal the Schur complement is numerically spent
#: (f32 eps is ~1.2e-7; duplicates under a deterministic noise floor land
#: here) and the factor falls back to a full jitter-ladder refactorization.
_RANK1_PIVOT_RTOL = 1e-6


def ladder_cholesky_rank1_update(
    L: torch.Tensor,
    k_row: torch.Tensor,
    slot: int,
    kernel_fn: Callable[[], torch.Tensor],
    *,
    initial_jitter: float = _LADDER_INITIAL_JITTER,
) -> tuple[torch.Tensor, int, int]:
    """Extend a ladder-Cholesky factor by one observation in O(n²) instead
    of refactorizing the whole Gram in O(n³): the scan loop's per-tell
    update.

    ``L`` is the (N, N) lower factor of the padded kernel whose rows
    ``< slot`` are real observations (appends are in slot order, so every
    row ``>= slot`` is padding). ``k_row`` is row ``slot`` of the extended
    kernel: cross-covariances against the buffer plus the noise-carrying
    diagonal at position ``slot``. A Cholesky factor's leading block depends
    only on the leading block of the matrix, so the append touches one row:
    one triangular solve for its off-diagonal entries and one Schur pivot
    for its diagonal. Padding rows keep their stale, decoupled entries.

    The pivot is the update's verdict, read to the host once: a non-finite
    or near-zero Schur complement (an exact-duplicate row under a
    deterministic noise floor) falls back to a full
    :func:`ladder_cholesky_with_rung` of ``kernel_fn()``, built only on that
    branch. Returns ``(L_new, rung, refactored)``; ``rung`` is 0 on the
    incremental path, ``refactored`` is 0 or 1.
    """
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    before = idx < slot
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    k_masked = torch.where(before, k_row, zero)
    l_off = torch.linalg.solve_triangular(L, k_masked[:, None], upper=False)[:, 0]
    l_off = torch.where(before, l_off, zero)
    diag = k_row[slot]
    pivot = diag - torch.sum(l_off * l_off)
    ok = (
        torch.all(torch.isfinite(l_off))
        & torch.isfinite(pivot)
        & (pivot > _RANK1_PIVOT_RTOL * torch.abs(diag))
    )
    if bool(ok):
        new_row = torch.where(idx == slot, torch.sqrt(torch.clamp(pivot, min=1e-30)), l_off)
        return torch.where((idx == slot)[:, None], new_row[None, :], L), 0, 0
    L_new, rung = ladder_cholesky_with_rung(kernel_fn(), initial_jitter=initial_jitter)
    return L_new, rung, 1


def ladder_cholesky_rank1_raise(
    L: torch.Tensor,
    v: torch.Tensor,
    kernel_fn: Callable[[], torch.Tensor],
    *,
    initial_jitter: float = _LADDER_INITIAL_JITTER,
) -> tuple[torch.Tensor, int, int]:
    """The ``L'`` with ``L'L'ᵀ = LLᵀ + vvᵀ`` in O(n²): the LINPACK ``dchud``
    sweep, one Givens-style rotation per column.

    The additive update of a positive-definite matrix cannot lose
    positivity, so a non-finite entry or non-positive diagonal after the
    sweep means f32 round-off on an ill-conditioned factor; the factor then
    falls back to a full :func:`ladder_cholesky_with_rung` of
    ``kernel_fn()`` (built only on that branch). Returns
    ``(L_new, rung, refactored)``; ``rung`` is 0 on the incremental path."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    Lc = L.clone()
    w = v.clone()
    for k in range(n):
        lkk = Lc[k, k]
        wk = w[k]
        r = torch.sqrt(lkk * lkk + wk * wk)
        c = r / lkk
        s = wk / lkk
        col = Lc[:, k]
        below = idx > k
        new_col = torch.where(below, (col + s * w) / c, col)
        new_col = torch.where(idx == k, r, new_col)
        w = torch.where(below, c * w - s * new_col, w)
        Lc[:, k] = new_col
    ok = torch.all(torch.isfinite(Lc)) & torch.all(torch.diagonal(Lc) > 0)
    if bool(ok):
        return Lc, 0, 0
    L_new, rung = ladder_cholesky_with_rung(kernel_fn(), initial_jitter=initial_jitter)
    return L_new, rung, 1


def clip_objective_values(values: np.ndarray) -> np.ndarray:
    """Clip ``±inf`` (and beyond-float32 magnitudes like ``1e308``) to the
    float32 extremes so a mean/std standardization stays finite end to end."""
    return np.clip(values, -_F32_MAX, _F32_MAX)


def collapse_duplicate_rows(
    X: np.ndarray, y: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse exact-duplicate design rows to one row with a count weight.

    Returns ``(X_unique, y_mean, counts)`` with first-occurrence order
    preserved; duplicate groups average their targets and carry the group
    size in ``counts``. Duplicate-free input is returned unchanged.
    """
    n = len(X)
    ones = np.ones(n, dtype=np.float32)
    if n == 0:
        return X, y, ones
    uniq, first, inverse, counts = np.unique(
        X, axis=0, return_index=True, return_inverse=True, return_counts=True
    )
    if len(uniq) == n:
        return X, y, ones
    order = np.argsort(first)  # chronological (first-occurrence) order
    sums = np.zeros(len(uniq), dtype=np.result_type(y.dtype, np.float32))
    np.add.at(sums, inverse, y)
    y_mean = (sums / counts)[order].astype(y.dtype)
    return (
        uniq[order].astype(X.dtype),
        y_mean,
        counts[order].astype(np.float32),
    )

# ------------------------------------------------- rings 2+3: the wrapper

#: The accepted ``fallback=`` policy literals and what each does when a
#: sampler fails.
FALLBACK_POLICIES: dict[str, str] = {
    "independent": "degrade: a sampler failure falls back to independent/random sampling",
    "raise": "strict: record the fallback attr, then re-raise the sampler's error",
}

#: System-attr namespace recording why a trial's suggestion fell back.
#: Deliberately *not* under ``batch_exec:`` (``storages/_callbacks.py::
#: EXECUTOR_ATTR_PREFIX``): fallback lineage describes the logical trial's
#: sampling, so retry-clone attr stripping must keep it.
SAMPLER_FALLBACK_ATTR_PREFIX = "sampler_fallback:"

#: Monotonic per-wrapper tokens for the warn-once keys: ``id(self)`` would
#: recycle after GC, letting a dead wrapper's suppression silence a new
#: wrapper's one-and-only warning in the process-global registry.
_guard_instance_seq = itertools.count()


def is_device_fault(err: BaseException) -> bool:
    """Whether ``err`` is a fault of the card or of a kernel's build, which
    :class:`GuardedSampler` never contains: a
    :class:`~optuna_tpu_torch.ops.kernels._nvcc.KernelBuildError`, a
    ``torch.AcceleratorError`` (where this torch has it) or
    ``torch.cuda.CudaError``, or a ``RuntimeError`` that reports a CUDA
    error (the CUDA runtime's own, or a kernel wrapper's failed launch)."""
    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError

    if isinstance(err, KernelBuildError):
        return True
    for cls in (getattr(torch, "AcceleratorError", None), getattr(torch.cuda, "CudaError", None)):
        if cls is not None and isinstance(err, cls):
            return True
    return isinstance(err, RuntimeError) and "CUDA error" in str(err)


def _is_non_finite_number(value: Any) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, (float, np.floating)):
        return not math.isfinite(float(value))
    return False


def non_finite_param_names(
    params: dict[str, Any],
    search_space: dict[str, BaseDistribution] | None = None,
) -> list[str]:
    """Names of proposed params carrying NaN/±inf values. Categorical dims
    are exempt when the search space is known — a choice may legally *be*
    the float ``nan`` object."""
    bad = []
    for name, value in params.items():
        if search_space is not None and isinstance(
            search_space.get(name), CategoricalDistribution
        ):
            continue
        if _is_non_finite_number(value):
            bad.append(name)
    return bad


class GuardedSampler(BaseSampler):
    """Containment wrapper: any sampler failure degrades per-trial instead
    of aborting the study.

    Guards every sampler hook: an exception from (or a non-finite proposal
    out of) ``infer_relative_search_space`` / ``sample_relative`` /
    ``sample_relative_batch`` / ``sample_independent`` is recorded as a
    ``sampler_fallback:<phase>`` system attr on the trial (study, for the
    batch hook — no trials exist yet), warned once per study, and resolved
    per the ``fallback`` policy: ``'independent'`` degrades to the wrapped
    sampler's independent path (a :class:`RandomSampler` if that path is
    itself broken); ``'raise'`` re-raises after recording, for callers that
    prefer a loud stop. ``fit_deadline_s`` bounds each relative fit on an
    injectable clock — a hung fit is abandoned on its watchdog thread and
    becomes an ordinary fallback.

    Wrapping is free on the happy path: no extra RNG draws, no extra
    storage reads — fault-free studies are bit-identical to the unwrapped
    sampler's.

    **A device fault is not contained** (the one difference from the
    reference): a CUDA error or a kernel build failure, which includes a
    built library that does not load (:func:`is_device_fault`), re-raises under either policy, and no host
    fallback is returned for it. A CUDA error is sticky — every later launch
    in the process fails too — so falling back to host random sampling
    would hide a dead kernel behind a study that "completes".
    """

    def __init__(
        self,
        sampler: BaseSampler,
        *,
        fallback: str = "independent",
        fit_deadline_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if fallback not in FALLBACK_POLICIES:
            raise ValueError(
                f"fallback must be one of {sorted(FALLBACK_POLICIES)}; "
                f"got {fallback!r}."
            )
        self._sampler = sampler
        self._fallback = fallback
        self._fit_deadline_s = fit_deadline_s
        self._clock = clock
        self._warn_token = next(_guard_instance_seq)
        self._fallback_random: BaseSampler | None = None
        # Autopilot actuator (``sampler.restart`` and
        # ``sampler.pin_independent`` drive it; pins also work by hand):
        # while any pin holds suggestions, the next relative suggestions skip the wrapped
        # sampler entirely and resolve every dimension through the
        # independent path — the pre-emptive form of the per-trial fallback
        # this wrapper already contains reactively (one decision instead of
        # N failed fits). Pins are tokened so two concurrent actions (a
        # stagnation burst and a storm pin) hold independent reservations:
        # undoing one must not cancel the other's. Active pins run
        # concurrently (each suggestion consumes one from every pin), they
        # do not stack into a longer horizon. ``n_jobs`` workers consume
        # pins together, so every read and write holds ``_pin_lock``.
        self._pins: dict[int, int] = {}
        self._pin_reasons: dict[int, str] = {}
        self._pin_lock = threading.Lock()
        #: Why the last ``sample_relative_batch`` call failed (None when it
        #: succeeded or declined). The batch executor reads it to tell the
        #: two Nones apart: a decline goes to per-trial relative sampling, a
        #: failure degrades the whole batch to independent sampling at once,
        #: never B more attempts of a broken fit.
        self.last_batch_fallback_reason: str | None = None

    @property
    def sampler(self) -> BaseSampler:
        """The wrapped sampler."""
        return self._sampler

    @property
    def fallback(self) -> str:
        """The active fallback policy."""
        return self._fallback

    def __str__(self) -> str:
        return f"GuardedSampler({self._sampler})"

    # -------------------------------------------- fitted-state checkpoints

    def export_fitted_state(self) -> "dict[str, Any] | None":
        """Delegate :mod:`optuna_tpu_torch.checkpoint`'s duck-typed fitted-state
        export to the wrapped sampler — the guard itself holds no posterior
        worth persisting (pins and fallback bookkeeping are per-process)."""
        hook = getattr(self._sampler, "export_fitted_state", None)
        return None if hook is None else hook()

    def restore_fitted_state(self, state: "Mapping[str, Any]") -> bool:
        """Warm-load a dead guard's exported fitted state into the wrapped
        sampler (True iff accepted); a re-homing hub calls this instead of
        paying a cold fit."""
        hook = getattr(self._sampler, "restore_fitted_state", None)
        return False if hook is None else bool(hook(state))

    # -------------------------------------------------- autopilot actuator

    @property
    def pinned_remaining(self) -> int:
        """Relative suggestions still pinned to the independent path (the
        widest active reservation; 0 when unpinned)."""
        with self._pin_lock:
            return max(self._pins.values(), default=0)

    def pin_independent(self, n_trials: int, reason: str = "pinned") -> int:
        """Pin the next ``n_trials`` relative suggestions to the independent
        path: the wrapped sampler's relative fit is skipped entirely (an
        empty relative proposal resolves every dimension independently).
        The autopilot's ``sampler.pin_independent`` / ``sampler.restart``
        actions call this — one decision instead of paying a failed (or
        pointless) fit per trial. Returns a token for
        :meth:`unpin_independent`; concurrent pins hold independent
        reservations (undoing one leaves the others standing) and run
        concurrently rather than stacking."""
        if n_trials < 1:
            raise ValueError(f"n_trials must be >= 1; got {n_trials}.")
        token = next(_guard_instance_seq)
        with self._pin_lock:
            self._pins[token] = int(n_trials)
            self._pin_reasons[token] = reason
        return token

    def unpin_independent(self, token: int | None = None) -> int:
        """Cancel one pin (or, with no token, every pin) — the autopilot's
        undo; returns how many pinned suggestions were still outstanding."""
        with self._pin_lock:
            if token is None:
                remaining = max(self._pins.values(), default=0)
                self._pins.clear()
                self._pin_reasons.clear()
                return remaining
            self._pin_reasons.pop(token, None)
            return self._pins.pop(token, 0)

    def _consume_pin(self, n: int) -> bool:
        """Advance every active pin by ``n`` suggestions; True while any
        was active (the suggestions are pinned)."""
        with self._pin_lock:
            if not self._pins:
                return False
            for token in list(self._pins):
                left = self._pins[token] - n
                if left > 0:
                    self._pins[token] = left
                else:
                    self._pins.pop(token)
                    self._pin_reasons.pop(token, None)
            return True

    # -------------------------------------------------------------- plumbing

    def _random(self) -> BaseSampler:
        if self._fallback_random is None:
            from optuna_tpu_torch.samplers._random import RandomSampler

            self._fallback_random = RandomSampler()
        return self._fallback_random

    def _timed(self, fn: Callable[[], Any], describe: str) -> Any:
        if self._fit_deadline_s is None:
            return fn()
        # Lazy import: executor lazily imports this module for its own
        # fallback knob — neither side pays a cycle at import time.
        from optuna_tpu_torch.parallel.executor import run_with_deadline

        return run_with_deadline(
            fn,
            self._fit_deadline_s,
            self._clock,
            describe=f"sampler {describe}",
            thread_name="optuna-tpu-sampler-fit",
        )

    def _contain(
        self,
        study: "Study",
        trial: FrozenTrial | None,
        phase: str,
        err: BaseException,
    ) -> None:
        """Record the fallback (attr + telemetry counter), warn once per
        study (:func:`~optuna_tpu_torch.logging.warn_once`), honor the policy.
        A device fault (:func:`is_device_fault`) is re-raised first, under
        either policy, with nothing recorded."""
        if is_device_fault(err):
            raise err
        reason = f"{type(err).__name__}: {err}"[:500]
        key = SAMPLER_FALLBACK_ATTR_PREFIX + phase
        # Count every containment event (family-bucketed: the per-param
        # ``independent:<name>`` phases collapse to ``independent`` so the
        # counter cardinality stays bounded by the hook vocabulary).
        telemetry.count("sampler.fallback." + phase.split(":", 1)[0])
        try:
            if trial is not None:
                study._storage.set_trial_system_attr(trial._trial_id, key, reason)
            else:
                study._storage.set_study_system_attr(study._study_id, key, reason)
        except Exception as attr_err:  # the attr is diagnostics; a storage blip on it must not turn a contained sampler failure into a study abort
            _logger.warning(
                f"recording sampler fallback attr {key!r} raised {attr_err!r}; "
                "continuing with the fallback anyway."
            )
        # The first degrade per (wrapper, study) flushes the flight recorder's
        # tail (a no-op while flight is off): the events that led to a broken
        # fit are what a later "why did the sampler degrade" asks for.
        flight.postmortem(
            f"sampler degraded during {phase}: {reason}"[:500],
            key=f"guarded_sampler:{self._warn_token}:{study._study_id}",
        )
        if self._fallback == "raise":
            raise err
        warn_once(
            _logger,
            f"guarded_sampler:{self._warn_token}:{study._study_id}",
            f"{type(self._sampler).__name__} failed during {phase} "
            f"({reason}); falling back to independent sampling. Further "
            "fallbacks in this study are recorded in "
            f"'{SAMPLER_FALLBACK_ATTR_PREFIX}*' system attrs (and the "
            "sampler.fallback telemetry counter) without a log line.",
        )

    def autopilot_densify(self):
        """Delegate the ``gp.densify`` actuator to the wrapped sampler; the
        containment keeps working unchanged after the inner engine widens."""
        inner = getattr(self._sampler, "autopilot_densify", None)
        if inner is None:
            raise AttributeError(f"{type(self._sampler).__name__} has no sparse-GP engine to densify")
        return inner()

    # ----------------------------------------------------------------- hooks

    def reseed_rng(self) -> None:
        self._sampler.reseed_rng()

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        try:
            return self._sampler.infer_relative_search_space(study, trial)
        except Exception as err:  # ring-2 containment boundary: any sampler crash degrades this trial to independent sampling instead of aborting the study ('raise' policy re-raises in _contain)
            self._contain(study, trial, "search_space", err)
            return {}

    def sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        if self._consume_pin(1):
            # Autopilot pin: skip the wrapped sampler's fit for this trial —
            # an empty relative proposal routes every dimension through the
            # independent path (exactly the contained-fallback result,
            # decided up front instead of paid for per failed fit).
            return {}
        try:
            params = self._timed(
                lambda: self._sampler.sample_relative(study, trial, search_space),
                "relative fit",
            )
        except Exception as err:  # ring-2 containment boundary: any sampler crash (or fit-watchdog timeout) degrades this trial to independent sampling ('raise' policy re-raises in _contain)
            self._contain(study, trial, "relative", err)
            return {}
        bad = non_finite_param_names(params, search_space)
        if bad:
            self._contain(
                study,
                trial,
                "relative",
                ValueError(
                    f"non-finite proposal for {bad}: "
                    f"{ {k: params[k] for k in bad} }"
                ),
            )
            return {k: v for k, v in params.items() if k not in bad}
        return params

    def sample_relative_batch(
        self,
        study: "Study",
        search_space: dict[str, BaseDistribution],
        batch_size: int,
    ) -> list[dict[str, Any]] | None:
        """Guarded batch ask. Returns None — the per-trial path, which this
        wrapper guards trial by trial — when the wrapped sampler lacks the
        hook, declines, or fails."""
        self.last_batch_fallback_reason = None
        if self._consume_pin(batch_size):
            # Autopilot pin, batch form: answer the whole batch with empty
            # relative proposals in one decision (each consumes one pinned
            # suggestion; a pin narrower than the batch still covers it —
            # partial pins would split one dispatch into two sampling
            # regimes for no containment benefit).
            return [{} for _ in range(batch_size)]
        inner = getattr(self._sampler, "sample_relative_batch", None)
        if inner is None:
            return None
        try:
            return self._timed(
                lambda: inner(study, search_space, batch_size), "batch relative fit"
            )
        except Exception as err:  # ring-2 containment boundary: a batch-fit crash degrades the whole batch to independent sampling ('raise' policy re-raises in _contain)
            self.last_batch_fallback_reason = f"{type(err).__name__}: {err}"[:500]
            self._contain(study, None, "relative_batch", err)
            return None

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        try:
            value = self._sampler.sample_independent(
                study, trial, param_name, param_distribution
            )
        except Exception as err:  # ring-2 containment boundary (last ring before random): the independent path itself failing falls to a plain RandomSampler ('raise' policy re-raises in _contain)
            self._contain(study, trial, f"independent:{param_name}", err)
            return self._random().sample_independent(
                study, trial, param_name, param_distribution
            )
        if not isinstance(
            param_distribution, CategoricalDistribution
        ) and _is_non_finite_number(value):
            self._contain(
                study,
                trial,
                f"independent:{param_name}",
                ValueError(f"non-finite independent sample {value!r}"),
            )
            return self._random().sample_independent(
                study, trial, param_name, param_distribution
            )
        return value

    def before_trial(self, study: "Study", trial: FrozenTrial) -> None:
        try:
            self._sampler.before_trial(study, trial)
        except Exception as err:  # ring-2 containment boundary: a before_trial crash (e.g. state restore) must not strand the just-created trial ('raise' policy re-raises in _contain)
            self._contain(study, trial, "before_trial", err)

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        try:
            self._sampler.after_trial(study, trial, state, values)
        except Exception as err:  # ring-2 containment boundary: an after_trial crash (state persist, constraints eval) must not abort the finished trial's tell ('raise' policy re-raises in _contain)
            self._contain(study, trial, "after_trial", err)
