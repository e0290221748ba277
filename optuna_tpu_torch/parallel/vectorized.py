"""Vectorized trial evaluation: many trials per device dispatch (port of
``optuna_tpu/parallel/vectorized.py``).

The sampler asks B trials, their parameters are packed into dense tensors
on the device, the batched objective runs once, and the results are told
back through the normal storage path, so pruners, samplers and analysis
see ordinary trials. This is the engine behind BASELINE config #5 (the
256-way MLP study).

This module owns the objective side (packing, the memoized dispatch
wrappers); the fault-tolerant dispatch loop is
:class:`~optuna_tpu_torch.parallel.executor.ResilientBatchExecutor`, to
which :func:`optimize_vectorized` delegates. With a ``mesh`` (a
``torch.distributed`` ``DeviceMesh``; see
:mod:`optuna_tpu_torch.parallel.sharded`), a dispatch wrapper evaluates
this rank's rows of the batch and gathers the rest from the other ranks
(:class:`~optuna_tpu_torch.parallel._mesh.MeshDispatch`); a plain
:class:`VectorizedObjective` replicates across any other mesh axis.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Sequence

import numpy as np
import torch

from optuna_tpu_torch.distributions import BaseDistribution, CategoricalDistribution
from optuna_tpu_torch.trial._trial import Trial

if TYPE_CHECKING:
    from optuna_tpu_torch.storages._retry import RetryPolicy
    from optuna_tpu_torch.study.study import Study

class VectorizedObjective:
    """A batched objective over an explicit search space.

    ``fn`` maps ``{name: tensor of shape (B,)}`` (internal representations:
    float32 values; categorical params as int32 choice indices) to a
    tensor of shape ``(B,)`` or ``(B, n_objectives)`` (a ``(B, 1)`` column
    is accepted). ``_compiled_cache`` is a plain per-objective cache: the
    dispatch wrappers (:meth:`compiled`, :meth:`guarded`) and the scan
    loop's per-(pool size, device) device constants live there, so their
    lifetime follows the objective. Nothing is compiled: a wrapper is a
    Python closure, memoized so that every optimize call over this
    objective dispatches through the same one, as the reference's jit
    wrappers are, and each is wrapped by
    :func:`~optuna_tpu_torch.flight.instrument_jit` (``vectorized.compiled``
    / ``vectorized.guarded``): a new batch width is counted as a compile, a
    later one as a retrace.
    """

    def __init__(
        self,
        fn: Callable[[dict[str, torch.Tensor]], torch.Tensor],
        search_space: dict[str, BaseDistribution],
    ) -> None:
        self.fn = fn
        self.search_space = search_space
        self._compiled_cache: dict[tuple, Any] = {}

    def _memoized(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        wrapper = self._compiled_cache.get(key)
        if wrapper is None:
            from optuna_tpu_torch import flight

            label = "vectorized.guarded" if "guarded" in key else "vectorized.compiled"
            wrapper = self._compiled_cache[key] = flight.instrument_jit(build(), label)
        return wrapper

    def compiled(self, mesh: Any = None, batch_axis: str = "trials") -> Callable:
        """The plain dispatch wrapper for ``fn``, built once per key: ``fn``
        itself, or over a ``mesh`` a
        :class:`~optuna_tpu_torch.parallel._mesh.MeshDispatch` of it."""
        return self._memoized((mesh, batch_axis), lambda: _over_mesh(self.fn, mesh, batch_axis, guarded=False))

    def guarded(self, mesh: Any = None, batch_axis: str = "trials", non_finite: str = "fail") -> Callable:
        """The executor's wrapper: returns ``(values, finite_mask)`` with the
        mask computed on the device (see
        :func:`~optuna_tpu_torch.parallel.executor.build_non_finite_guard`).
        ``'fail'`` and ``'raise'`` share one wrapper; only ``'clip'``
        differs."""
        from optuna_tpu_torch.parallel.executor import build_non_finite_guard

        clip = non_finite == "clip"
        return self._memoized(
            (mesh, batch_axis, "guarded", clip),
            lambda: _over_mesh(build_non_finite_guard(self.fn, clip=clip), mesh, batch_axis, guarded=True),
        )


def _over_mesh(fn: Callable, mesh: Any, batch_axis: str, *, guarded: bool) -> Callable:
    if mesh is None:
        return fn
    from optuna_tpu_torch.parallel._mesh import MeshDispatch

    return MeshDispatch(fn, mesh, batch_axis, guarded=guarded)


def _pack_params(trials: Sequence[Trial], space: dict[str, BaseDistribution]) -> dict[str, np.ndarray]:
    """The batch's parameters as host columns: float32 internal values,
    int32 choice indices for categoricals."""
    cols: dict[str, np.ndarray] = {}
    for name, dist in space.items():
        vals = [dist.to_internal_repr(t._cached_frozen_trial.params[name]) for t in trials]
        dtype = np.int32 if isinstance(dist, CategoricalDistribution) else np.float32
        cols[name] = np.asarray(vals, dtype=dtype)
    return cols


def optimize_vectorized(
    study: "Study",
    objective: VectorizedObjective,
    n_trials: int,
    batch_size: int | None = None,
    mesh: Any = None,
    batch_axis: str = "trials",
    callbacks: Sequence[Callable] | None = None,
    *,
    non_finite: str = "fail",
    fallback: str | None = None,
    bisect_on_error: bool = True,
    retry_policy: "RetryPolicy | None" = None,
    dispatch_deadline_s: float | None = None,
    autopilot: "str | Any | None" = None,
    device: "str | torch.device | None" = None,
) -> None:
    """Run ``n_trials`` in batches of ``batch_size`` (default 8), one
    dispatch of the objective a batch, fault-tolerantly.

    ``device`` is where the packed parameters go and the objective runs:
    ``None`` is the card (and raises where there is none; with a ``mesh``,
    the mesh's device), ``"cpu"`` the plain PyTorch path. A ``mesh`` (a
    ``DeviceMesh`` with a ``batch_axis`` dimension, e.g. a 1-D ``trials``
    mesh) shards each batch's rows over that axis: on several ranks, rank 0
    runs the sampler and the storage and broadcasts each batch, and every
    other rank, calling this function alike, evaluates its rows until rank
    0's run ends (see :mod:`optuna_tpu_torch.parallel.sharded`); ``study``
    is not read there. ``batch_size`` defaults to the shard count with a
    mesh. Execution is delegated to
    :class:`~optuna_tpu_torch.parallel.executor.ResilientBatchExecutor`:
    ``non_finite`` picks the NaN/Inf quarantine policy
    (``'fail'``/``'raise'``/``'clip'``), ``fallback`` the sampler-fault
    policy (``'independent'`` degrades a raising or NaN-proposing sampler
    to per-trial independent sampling, with ``sampler_fallback:`` attrs;
    ``'raise'`` surfaces it; ``None`` inherits a ``GuardedSampler`` study's
    own policy), ``bisect_on_error`` isolates poison trials by bisecting
    the batch, ``retry_policy`` paces OOM halving, and
    ``dispatch_deadline_s`` bounds a hung dispatch, and ``autopilot``
    (``"observe"``, ``"act"`` or an
    :class:`~optuna_tpu_torch.autopilot.AutopilotPolicy`) arms the
    doctor-driven control loop for this run, with the executor's batch-width
    knobs and a ``GuardedSampler``'s pins as its actuators.
    """
    from optuna_tpu_torch.parallel.executor import ResilientBatchExecutor

    ResilientBatchExecutor(
        study,
        objective,
        batch_size=batch_size,
        mesh=mesh,
        batch_axis=batch_axis,
        callbacks=callbacks,
        non_finite=non_finite,
        fallback=fallback,
        bisect_on_error=bisect_on_error,
        retry_policy=retry_policy,
        dispatch_deadline_s=dispatch_deadline_s,
        autopilot=autopilot,
        device=device,
    ).run(n_trials)
