"""Device-resident study loop: ask -> evaluate -> tell on the device
(PyTorch port of ``optuna_tpu/parallel/scan_loop.py``).

The per-trial GP path pays a host round trip per suggestion and a full
O(n³) Gram factorization per fit. This loop keeps the study itself on the
device:

* **Power-of-two buckets** — trial history (X, y-scores, a real-row mask)
  lives in device buffers padded to power-of-two sizes; a bucket crossing
  copies the buffers device to device into the next size.
* **One program per chunk** — each ``sync_every`` trials are one chunk: a
  MAP kernel-param fit (multi-start L-BFGS, warm-started from the previous
  chunk) and one jitter-ladder factorization up front, then ``chunk_len``
  steps that propose by LogEI over the device Sobol pool, evaluate the
  user's batched objective, and tell by **incremental factor update**:
  :func:`~optuna_tpu_torch.samplers._resilience.ladder_cholesky_rank1_update`
  appends the new row in O(n²) and falls back to a full refactorization
  only when the pivot is spent. Above ``n_exact_max`` the chunk is the SGPR
  twin: an O(nm²) reduction at the boundary, O(m²) rank-1 raises per tell,
  variance swap-ins into the inducing set.
* **Chunked storage sync** — COMPLETE/FAIL trials reach storage once per
  chunk. Each synced trial is logically identical to the per-trial path's:
  params under their distributions, COMPLETE with the value or FAIL with a
  ``fail_reason`` attr, callbacks fired, exactly once, stamped with its op
  token (``ckpt:op``).
* **Quarantine** — a non-finite objective value is never ingested: the
  buffers, the factor, the cursor and the inducing set stay as they were,
  and the slot is told FAIL at the sync.
* **Observability** — each chunk returns a device-stats struct (ladder
  rung, row appends vs refactorizations, quarantines, chunk fill, and the
  inducing-set stats on the sparse path) that the sync harvests; the chunk
  and the sync are the ``scan.chunk`` / ``scan.sync`` telemetry phases and
  ``torch.profiler`` ranges.

**How a chunk runs here.** The reference runs a chunk as one jitted
``lax.scan`` whose tells branch in-graph through ``lax.cond``: finite or
quarantine, swap-in or rank-1 raise, append or refactor. The port's L-BFGS
reads its convergence to the host once per iteration, and so does each
jitter ladder, so a chunk here is a Python loop of ``chunk_len`` steps over
device tensors, and each ``lax.cond`` is one host read of its verdict
followed by one branch. Host reads per step (the objective's own aside):

* exact: the acquisition ascent's L-BFGS, one per iteration (at most
  ``lbfgs_iters``); the finite verdict; the row-append verdict. At most
  ``lbfgs_iters + 2``; a refactorization adds one per ladder rung tried.
* sparse: the ascent (at most ``lbfgs_iters``); the finite and swap
  verdicts, read together; then the rank-1 raise's verdict (1) or, on a
  swap-in, the four ladders of ``sgpr_reduce`` (4). At most
  ``lbfgs_iters + 2`` on a tell step and ``lbfgs_iters + 5`` on a swap.

Per chunk come the fit's L-BFGS reads (one per iteration), the boundary
factorizations' ladders, and at the sync the read-back of the chunk's
points, values and stats. Besides these reads, five calls a step
synchronize: the ascent's three winner gathers in ``gp/fused.py``
(indexing with a 0-dim device tensor), the line-search step table that
``ops/lbfgsb.py`` uploads per call, and the host scalar written into the
mask on a tell. Counted on an H100 with ``torch.cuda.
set_sync_debug_mode("warn")`` (``scripts/torch_scan_probe.py``), a chunk's
fit and sync spread over its 32 steps: 11.8 synchronizing calls a step
exact at bucket 1024 (4.1 of them L-BFGS exit tests, the fit's and the
ascent's), 19.0 sparse at bucket 4096 (10.3). The reference has no host
read inside a chunk; capturing a chunk as one CUDA graph is ROADMAP work.

Three rules keep the reference's contract:

* **Order.** Chunk k+1 runs, then chunk k is synced. Nothing overlaps
  (a chunk ends in host reads), but the order lets ``Study.stop()`` from a
  callback discard chunk k+1 before any of its trials exist.
* **Explicit draws.** The reference draws each step's candidate shift and
  start-selection Gumbels from ``fold_in(key, i)``. The chunk programs here
  take them as tensors, ``shifts (chunk_len, d)`` and
  ``gumbels (chunk_len, 4 + C)``; :func:`_run_scan` draws them from a
  ``torch.Generator`` on the device seeded only by ``(key_seed,
  chunk_idx)``, so a chunk's draws do not depend on what ran before it.
* **f32 standardization on the device** with the chunk-start moments and
  scores clipped to ±``_SCAN_SCORE_CLIP``, as the reference does (not the
  f64 host standardization of GPSampler).

Scope: single-objective studies, explicit Float/Int/Categorical spaces,
batched objectives (:class:`~optuna_tpu_torch.parallel.vectorized.
VectorizedObjective`, batch width 1 inside a chunk). The study's sampler is
bypassed. The decode on the device mirrors the host ``unnormalize_one``
(step snapping included) in f32: the objective sees the device decode,
storage records the host f64 decode of the same point.

**Preemption resume.** After every chunk sync the loop writes the carry
that re-dispatches the next chunk into the ``ckpt:scan:*`` ring
(:mod:`optuna_tpu_torch.checkpoint`): the bucket, the history buffers, the
cursor, the warm start, the inducing buffers, the draw seed, the chunk
index and the host RNG's state, each realized to NumPy after the sync (no
host read is added inside a chunk). ``optimize_scan(resume=True)`` rebuilds
that carry and re-runs the interrupted chunk, which repeats its draws
because they depend only on ``(key_seed, chunk_idx)``; the op tokens skip
what the dead run told and adopt its token-stamped RUNNING strays.

**Observability and control.** The chunk and its sync are telemetry,
flight and profiler spans; each synced trial's ask and tell are flight
events. The health reporter and the autopilot attach at the loop's entry
and publish/step at every sync, after its one read-back, so they add no
host read inside a chunk. ``study._scan_gp_control`` holds the live
large-n thresholds and is re-read at every chunk: the autopilot's
``gp.densify`` answers a ``gp.sparse_degraded`` finding by doubling its
``n_inducing``, and the next chunk re-seeds its inducing set at the new
power-of-two capacity. Because chunk k+1 is dispatched before chunk k
syncs, a decision taken at chunk k's sync first shapes chunk k+2.
``OPTUNA_TPU_TORCH_TRACE=<logdir>`` profiles the whole run.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, NamedTuple, Sequence

import numpy as np
import torch

from optuna_tpu_torch import _tracing, autopilot, device_stats, flight, health, telemetry
from optuna_tpu_torch import checkpoint as _ckpt
from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from optuna_tpu_torch.exceptions import UpdateFinishedTrialError
from optuna_tpu_torch.gp.acqf import LogEIData
from optuna_tpu_torch.gp.fused import _fit_params, _maximize_logei, device_candidates, gumbel_noise
from optuna_tpu_torch.gp.gp import _JITTER, GPState, _bucket, _kernel_with_noise, matern52, posterior
from optuna_tpu_torch.gp.search_space import ScaleType, SearchSpace
from optuna_tpu_torch.gp.sparse import (
    N_EXACT_MAX,
    N_INDUCING_MAX,
    SWAP_VAR_FRAC,
    _pow2_bucket,
    _select_inducing_device,
    sgpr_reduce,
    sparse_tell,
)
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.samplers._resilience import (
    ladder_cholesky_rank1_update,
    ladder_cholesky_with_rung,
)
from optuna_tpu_torch.trial._state import TrialState
from optuna_tpu_torch.trial._trial import Trial

if TYPE_CHECKING:
    from optuna_tpu_torch.parallel.vectorized import VectorizedObjective
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)

_TRACE_CHUNK = telemetry.trace_name("scan.chunk")
_TRACE_SYNC = telemetry.trace_name("scan.sync")
_TRACE_DISPATCH = telemetry.trace_name("dispatch")

#: Kernel-param fit budgets: (n_starts, lbfgs_iters). The first chunk runs
#: the cold multi-start; every later chunk refines 2 starts (default + the
#: previous chunk's optimum).
_SCAN_COLD_FIT = (4, 48)
_SCAN_WARM_FIT = (2, 16)
_STABILIZING_NOISE = 1e-10

#: Score-buffer clip bound. The chunk standardizes in f32, where squaring an
#: f32-max score overflows the variance to inf and blinds the GP; 1e15 keeps
#: n·(2·clip)² inside f32 range while keeping the ordering a huge or ±inf
#: objective conveys (storage still receives the unclipped value).
_SCAN_SCORE_CLIP = 1e15

#: Recent incumbents that join each step's candidate pool.
_N_INCUMBENTS = 4


class _Chunk(NamedTuple):
    """What one chunk program returns."""

    xs: torch.Tensor  # (chunk_len, d) proposals, normalized
    vals: torch.Tensor  # (chunk_len,) objective values
    finites: np.ndarray  # (chunk_len,) bool, the quarantine verdicts read on the host
    X: torch.Tensor  # history buffers after the chunk
    y: torch.Tensor
    mask: torch.Tensor
    n: int  # cursor after the chunk
    raw: torch.Tensor  # fitted raw kernel params: the next chunk's warm start
    stats: dict  # DEVICE_STATS struct
    acq: torch.Tensor  # (chunk_len,) LogEI of each proposal under the model that proposed it
    Z: torch.Tensor | None = None  # sparse: inducing buffers after the chunk,
    zy: torch.Tensor | None = None  # targets de-standardized
    zmask: torch.Tensor | None = None
    swaps: tuple = ()  # sparse: the per-step swap-in verdicts read on the host


def _make_decode(space: SearchSpace) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """Device-side normalized -> internal-repr decode mirroring
    ``SearchSpace.unnormalize_one``: categorical dims become int32 choice
    indices, numeric dims map through the (possibly log) bounds with step
    snapping, in f32. Built once per program from static per-dim metadata."""
    specs = []
    for i, name in enumerate(space.param_names):
        dist = space._search_space[name]
        scale = int(space.scale_types[i])
        lo, hi = float(space.bounds[i][0]), float(space.bounds[i][1])
        step = None
        if isinstance(dist, IntDistribution):
            step = float(dist.step)
        elif isinstance(dist, FloatDistribution) and dist.step is not None:
            step = float(dist.step)
        low = None if isinstance(dist, CategoricalDistribution) else float(dist.low)
        high = None if isinstance(dist, CategoricalDistribution) else float(dist.high)
        specs.append((name, scale, lo, hi, step, low, high))

    def decode(x: torch.Tensor) -> dict[str, torch.Tensor]:
        cols: dict[str, torch.Tensor] = {}
        for i, (name, scale, lo, hi, step, low, high) in enumerate(specs):
            col = x[:, i]
            if scale == ScaleType.CATEGORICAL:
                cols[name] = torch.round(col).to(torch.int32)
                continue
            raw = lo + torch.clamp(col, 0.0, 1.0) * (hi - lo)
            if scale == ScaleType.LOG:
                raw = torch.exp(raw)
            if step is not None:
                raw = low + step * torch.round((raw - low) / step)
            if low is not None and step is not None:
                raw = torch.clamp(raw, low, high)
            cols[name] = raw.to(torch.float32)
        return cols

    return decode


def _single_objective_values(vals: torch.Tensor, batch: int) -> torch.Tensor:
    """The objective's output as shape (batch,); a (B, 1) column is accepted."""
    return torch.reshape(vals, (batch,))


def _device_space(
    objective: "VectorizedObjective", space: SearchSpace, n_preliminary: int, device: torch.device
):
    """The per-space device constants (Sobol pool, bounds, sweep tables),
    cached on the objective per (pool size, device)."""
    key = ("scan_devspace", n_preliminary, str(device))
    dev = objective._compiled_cache.get(key)
    if dev is None:
        from optuna_tpu_torch.samplers._gp.sampler import _DeviceSpace

        dev = _DeviceSpace(space, n_preliminary, device)
        objective._compiled_cache[key] = dev
    return dev


def _startup_program(objective: "VectorizedObjective", space: SearchSpace):
    """Evaluator of the random-startup block: decode, the objective and the
    finite verdict over a batch of Sobol points."""
    decode = _make_decode(space)
    fn = objective.fn

    def eval_batch(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        vals = _single_objective_values(fn(decode(x)), x.shape[0])
        return vals, torch.isfinite(vals)

    return eval_batch


def _chunk_moments(y: torch.Tensor, mask: torch.Tensor):
    """(mu, sd, y_std): the chunk-start standardization of the score buffer,
    in f32 on the device, over the real rows."""
    n_f = torch.clamp(torch.sum(mask), min=1.0)
    mu = torch.sum(y * mask) / n_f
    sd = torch.sqrt(torch.clamp(torch.sum(mask * (y - mu) ** 2) / n_f, min=0.0))
    sd = torch.where(sd > 1e-12, sd, torch.ones_like(sd))
    y_std = torch.where(mask > 0, (y - mu) / sd, torch.zeros_like(y))
    return mu, sd, y_std


def _incumbent_best(y_std: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    masked = torch.where(mask > 0, y_std, torch.full_like(y_std, -float("inf")))
    return torch.where(torch.sum(mask) > 0, torch.max(masked), torch.zeros_like(y_std[0]))


def _scored(val: torch.Tensor, maximize: bool, mu, sd):
    """(finite verdict, clipped score, standardized score) of one value."""
    finite = torch.isfinite(val)
    score = val if maximize else -val
    score = torch.clamp(
        torch.where(finite, score, torch.zeros_like(score)), -_SCAN_SCORE_CLIP, _SCAN_SCORE_CLIP
    )
    return finite, score, (score - mu) / sd


def _candidates(dev, X: torch.Tensor, n: int, shift: torch.Tensor) -> torch.Tensor:
    """The step's pool: the ``_N_INCUMBENTS`` most recent history rows
    (indices clamped into the bucket, as the reference's gather clamps them)
    ahead of the shifted Sobol pool."""
    back = torch.arange(_N_INCUMBENTS, device=X.device)
    inc = X[torch.clamp(n - 1 - back, 0, X.shape[0] - 1)]
    cand = device_candidates(dev.sobol_base, shift, dev.cat_mask, dev.n_choices, dev.steps)
    return torch.cat([inc, cand], dim=0)


def _propose(dev, data: LogEIData, cand, gumbel, *, n_local_search: int, lbfgs_iters: int):
    x_i, v_i, _ = _maximize_logei(
        data, cand, gumbel, dev.cont_mask, dev.lower, dev.upper,
        dev.dim_onehot, dev.choice_grid, dev.choice_valid,
        n_local_search=n_local_search, n_cycles=1,
        lbfgs_iters=lbfgs_iters, has_sweep=dev.has_sweep,
    )
    return x_i, v_i


def _chunk_program(
    objective: "VectorizedObjective",
    space: SearchSpace,
    dev,
    *,
    fit_iters: int,
    minimum_noise: float,
    maximize: bool,
    n_local_search: int,
    lbfgs_iters: int,
):
    """The exact chunk program: fit + chunk factorization + one
    ask/evaluate/tell step per row of ``shifts``.

    Returns ``chunk_fn(starts, X, y, mask, n_real, shifts, gumbels) ->
    _Chunk``; ``n_real`` is the history cursor (a host int), the history
    tensors are not modified."""
    decode = _make_decode(space)
    fn = objective.fn
    cat_mask = dev.cat_mask

    @torch.no_grad()
    def chunk_fn(starts, X, y, mask, n_real: int, shifts, gumbels) -> _Chunk:
        X, y, mask = X.clone(), y.clone(), mask.clone()
        # y holds raw scores (direction-applied, clipped); standardize once
        # per chunk with the chunk-start moments. The fit conditions on this
        # standardization, and the next chunk boundary re-centers.
        mu, sd, y_std = _chunk_moments(y, mask)
        raw, params, fit_n_iter = _fit_params(
            starts, X, y_std, cat_mask, mask, minimum_noise, fit_iters
        )
        # One full factorization per chunk (the kernel params just moved);
        # every tell below is an incremental row append.
        L, rung0 = ladder_cholesky_with_rung(_kernel_with_noise(X, params, cat_mask, mask))
        alpha = torch.cholesky_solve(y_std[:, None], L)[:, 0]
        best = _incumbent_best(y_std, mask)
        noise_c = torch.tensor(_STABILIZING_NOISE, dtype=X.dtype, device=X.device)
        idx = torch.arange(X.shape[0], device=X.device)
        self_cov = params.scale + params.noise + _JITTER
        n = n_real
        r1 = rf = rung_max = quar = 0
        xs, vals, acqs, finites = [], [], [], []
        for i in range(shifts.shape[0]):
            state = GPState(params=params, X=X, y=y_std, mask=mask, L=L, alpha=alpha)
            data = LogEIData(state=state, cat_mask=cat_mask, best=best, stabilizing_noise=noise_c)
            x_i, v_i = _propose(
                dev, data, _candidates(dev, X, n, shifts[i]), gumbels[i],
                n_local_search=n_local_search, lbfgs_iters=lbfgs_iters,
            )
            val = _single_objective_values(fn(decode(x_i[None])), 1)[0]
            finite_t, score, score_std = _scored(val, maximize, mu, sd)
            xs.append(x_i)
            vals.append(val)
            acqs.append(v_i)
            finite = bool(finite_t)  # host read: the quarantine verdict
            finites.append(finite)
            if not finite:
                # Never ingested: buffers, factor and cursor stay as they
                # are; the slot exists only in the outputs, told FAIL at sync.
                quar += 1
                continue
            X[n] = x_i
            mask[n] = 1.0
            y[n] = score
            y_std[n] = score_std
            # Row n of the extended kernel: cross-covariances against the
            # buffer, with the noise-carrying self-covariance at n.
            k_row = torch.where(idx == n, self_cov, matern52(x_i[None], X, params, cat_mask)[0])
            L, rung_i, refac = ladder_cholesky_rank1_update(
                L, k_row, n, lambda: _kernel_with_noise(X, params, cat_mask, mask)
            )
            alpha = torch.cholesky_solve(y_std[:, None], L)[:, 0]
            best = torch.maximum(best, score_std)
            n += 1
            r1 += 1 - refac
            rf += refac
            rung_max = max(rung_max, rung_i)
        stats = {
            "gp.ladder_rung": max(rung0, rung_max),
            "gp.fit_iterations": fit_n_iter,
            "scan.rank1_updates": r1,
            "scan.refactorizations": rf,
            "scan.quarantined": quar,
            "scan.chunk_fill": n - n_real,
        }
        return _Chunk(
            torch.stack(xs), torch.stack(vals), np.asarray(finites, dtype=bool),
            X, y, mask, n, raw, stats, torch.stack(acqs),
        )

    return chunk_fn


def _seed_inducing_program(m_pad: int):
    """Inducing-set seeder for the first sparse chunk (and for re-seeding
    after the capacity changes): farthest-point selection over the live
    bucket on the device, gathered into fixed-shape ``(m_pad, d)`` buffers.
    The Sobol startup block fronts the history, so the greedy's
    space-filling picks come from it first."""

    @torch.no_grad()
    def seed(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
        idx, valid = _select_inducing_device(X, mask, m_pad)
        zmask = valid.to(X.dtype)
        return X[idx], torch.where(zmask > 0, y[idx], torch.zeros_like(zmask)), zmask

    return seed


def _chunk_program_sparse(
    objective: "VectorizedObjective",
    space: SearchSpace,
    dev,
    *,
    fit_iters: int,
    minimum_noise: float,
    maximize: bool,
    n_local_search: int,
    lbfgs_iters: int,
):
    """The large-n twin of :func:`_chunk_program`: the same steps, with the
    posterior the SGPR inducing-point reduction over a fixed-shape
    ``(m_pad, d)`` inducing set carried beside the history buffers.

    Per chunk boundary: a subset MAP fit on the inducing set and one
    :func:`~optuna_tpu_torch.gp.sparse.sgpr_reduce` over the full bucket
    (its cross-covariance is the CUDA Matérn Gram on the card). Per step:
    propose from the m-point state, then tell by either an O(m²) rank-1
    raise (:func:`~optuna_tpu_torch.gp.sparse.sparse_tell`) when the point
    is well covered, or a **swap-in** when its pre-tell variance exceeds
    ``SWAP_VAR_FRAC``·scale (or a slot is empty): the first empty slot, else
    the most redundant point (min nearest-neighbour distance), takes it and
    the reduction is rebuilt. Each proposal's one-step-ahead residual
    |μ(x) − y_std(x)| is accumulated before ingestion
    (``gp.sparse_heldout_err``). A quarantined value touches neither the
    history nor the factors nor the inducing set.

    Returns ``chunk_fn(starts, X, y, mask, n_real, Z, zy, zmask, shifts,
    gumbels) -> _Chunk``.
    """
    decode = _make_decode(space)
    fn = objective.fn
    cat_mask = dev.cat_mask

    @torch.no_grad()
    def chunk_fn(starts, X, y, mask, n_real: int, Z, zy, zmask, shifts, gumbels) -> _Chunk:
        X, y, mask = X.clone(), y.clone(), mask.clone()
        # The same full-history standardization as the exact program, so the
        # sparse/exact transition never shifts the target scale.
        mu, sd, y_std = _chunk_moments(y, mask)
        zy_s = torch.where(zmask > 0, (zy - mu) / sd, torch.zeros_like(zy))
        raw, params, fit_n_iter = _fit_params(
            starts, Z, zy_s, cat_mask, zmask, minimum_noise, fit_iters
        )
        st, Lmm, L_B, b, rung0 = sgpr_reduce(params, Z, zy_s, zmask, X, y_std, mask, cat_mask)
        best = _incumbent_best(y_std, mask)
        noise_c = torch.tensor(_STABILIZING_NOISE, dtype=X.dtype, device=X.device)
        m_pad = Z.shape[0]
        slots = torch.arange(m_pad, device=X.device)
        eye_off = ~torch.eye(m_pad, dtype=torch.bool, device=X.device)
        inf = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
        herr = torch.zeros((), dtype=X.dtype, device=X.device)
        n = n_real
        r1 = rf = swaps = rung_max = quar = 0
        xs, vals, acqs, finites, swapped = [], [], [], [], []
        for i in range(shifts.shape[0]):
            data = LogEIData(state=st, cat_mask=cat_mask, best=best, stabilizing_noise=noise_c)
            x_i, v_i = _propose(
                dev, data, _candidates(dev, X, n, shifts[i]), gumbels[i],
                n_local_search=n_local_search, lbfgs_iters=lbfgs_iters,
            )
            val = _single_objective_values(fn(decode(x_i[None])), 1)[0]
            finite_t, score, score_std = _scored(val, maximize, mu, sd)
            # One-step-ahead residual, measured before the tell.
            mean_i, var_i = posterior(st, x_i[None], cat_mask)
            herr = herr + torch.where(finite_t, torch.abs(mean_i[0] - score_std), torch.zeros_like(herr))
            # Coverage test on the pre-tell variance (stale by design).
            any_empty = torch.any(zmask < 0.5)
            need_swap_t = (var_i[0] > SWAP_VAR_FRAC * params.scale) | any_empty
            xs.append(x_i)
            vals.append(val)
            acqs.append(v_i)
            finite, need_swap = torch.stack([finite_t, need_swap_t]).tolist()  # one host read
            finites.append(finite)
            if not finite:
                quar += 1
                continue
            X[n] = x_i
            mask[n] = 1.0
            y[n] = score
            y_std[n] = score_std
            swapped.append(need_swap)
            if need_swap:
                zd2 = torch.sum((Z[:, None, :] - Z[None, :, :]) ** 2, dim=-1)
                live = zmask > 0
                nn = torch.amin(torch.where(live[:, None] & live[None, :] & eye_off, zd2, inf), dim=1)
                redundant = torch.argmin(torch.where(live, nn, inf))
                slot = torch.where(any_empty, torch.argmin(zmask), redundant)
                hit = slots == slot
                Z = torch.where(hit[:, None], x_i[None], Z)
                zy_s = torch.where(hit, score_std, zy_s)
                zmask = torch.where(hit, torch.ones_like(zmask), zmask)
                st, Lmm, L_B, b, rung_i = sgpr_reduce(
                    params, Z, zy_s, zmask, X, y_std, mask, cat_mask
                )
                swaps += 1
                rung_max = max(rung_max, rung_i)
            else:
                st, L_B, b, refac = sparse_tell(st, Lmm, L_B, b, x_i, score_std, cat_mask)
                r1 += 1 - refac
                rf += refac
            best = torch.maximum(best, score_std)
            n += 1
        fill = n - n_real
        m_live = torch.sum(zmask > 0).to(torch.int32)
        n_live = torch.sum(mask > 0)
        stats = {
            "gp.ladder_rung": max(rung0, rung_max),
            "gp.fit_iterations": fit_n_iter,
            "scan.rank1_updates": r1,
            "scan.refactorizations": rf,
            "scan.quarantined": quar,
            "scan.chunk_fill": fill,
            "gp.inducing_count": m_live,
            "gp.sparsity_ratio": m_live.to(torch.float32) / torch.clamp(n_live, min=1).to(torch.float32),
            "gp.inducing_swaps": swaps,
            "gp.sparse_heldout_err": herr / max(fill, 1),
        }
        # De-standardize the inducing targets so the carried buffer is
        # chunk-invariant (the next chunk re-standardizes with its moments).
        zy_raw = torch.where(zmask > 0, zy_s * sd + mu, torch.zeros_like(zy_s))
        return _Chunk(
            torch.stack(xs), torch.stack(vals), np.asarray(finites, dtype=bool),
            X, y, mask, n, raw, stats, torch.stack(acqs), Z, zy_raw, zmask, tuple(swapped),
        )

    return chunk_fn


def _chunk_draws(
    key_seed: int, chunk_idx: int, chunk_len: int, d: int, n_cand: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(shifts (chunk_len, d), gumbels (chunk_len, n_cand)) of one chunk, from
    a generator on ``device`` seeded only by ``(key_seed, chunk_idx)``."""
    seed = int(np.random.SeedSequence([key_seed, chunk_idx]).generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shifts = torch.rand((chunk_len, d), generator=gen, device=device, dtype=torch.float32)
    gumbels = gumbel_noise(chunk_len * n_cand, gen, device).reshape(chunk_len, n_cand)
    return shifts, gumbels


def _publish_chunk(stats) -> None:
    """Chunk-boundary observability publish: one harvest per chunk, nothing
    while telemetry and the flight recorder are off."""
    if not device_stats.enabled():
        return
    device_stats.harvest(stats)


def _clip_scores(scores: np.ndarray) -> np.ndarray:
    """Bound host-produced scores (history resume, startup block) to the
    range the chunk's f32 standardization can square."""
    return np.clip(scores, -_SCAN_SCORE_CLIP, _SCAN_SCORE_CLIP).astype(np.float32)


def _validate_space(space_dict: dict[str, BaseDistribution]) -> None:
    if not space_dict:
        raise ValueError("optimize_scan needs a non-empty explicit search space.")
    for name, dist in space_dict.items():
        if not isinstance(dist, (FloatDistribution, IntDistribution, CategoricalDistribution)):
            raise ValueError(
                f"optimize_scan supports Float/Int/Categorical distributions; "
                f"param {name!r} has {type(dist).__name__}."
            )


def optimize_scan(
    study: "Study",
    objective: "VectorizedObjective",
    n_trials: int,
    *,
    sync_every: int = 32,
    n_startup_trials: int = 16,
    seed: int | None = None,
    deterministic_objective: bool = False,
    callbacks: Sequence[Callable] | None = None,
    n_preliminary_samples: int = 512,
    n_local_search: int = 4,
    lbfgs_iters: int = 16,
    n_exact_max: int | None = None,
    n_inducing: int | None = None,
    resume: bool = False,
    device: "str | torch.device | None" = None,
) -> None:
    """Run ``n_trials`` GP-BO trials with the ask/evaluate/tell cycle on the
    device (see the module docstring for the design).

    ``sync_every`` sets both the chunk length and the storage-sync cadence.
    ``n_startup_trials`` random (scrambled-Sobol) trials seed the GP in one
    batched evaluation before the first chunk; a study that already holds
    COMPLETE trials over this search space starts from them. ``seed`` drives
    the Sobol startup and every chunk's draws, so a fixed seed reproduces
    the study on one device. Non-finite objective values are quarantined
    (never ingested) and told FAIL at the chunk sync.

    Once the history would exceed ``n_exact_max`` (default
    :data:`optuna_tpu_torch.gp.sparse.N_EXACT_MAX`), chunks take the SGPR
    program with an inducing set of up to ``n_inducing`` points (default
    :data:`~optuna_tpu_torch.gp.sparse.N_INDUCING_MAX`, capacity rounded up
    to a power of two). The thresholds live in ``study._scan_gp_control``
    and are re-read at every chunk.

    **Preemption resume.** With ``resume=True``, ``n_trials`` is the
    study's *total* tell budget: the loop first reaps RUNNING strays a dead
    process left behind, then rebuilds the device carry from the newest
    valid ``ckpt:scan:*`` blob (written after every chunk sync) and re-runs
    the interrupted chunk with the same draws, skipping ops the dead run
    already told, so an uninterrupted twin and a kill-then-resume run land
    on the same trials. When no blob survives validation (counted
    ``checkpoint.fallback``), the loop degrades to its ordinary
    recompute-from-COMPLETE-history warm start with the already-synced tells
    still counted against the budget. The ``seed`` / ``sync_every`` of the
    original call must be passed again; a ``sync_every`` or search-space
    mismatch rejects the blob.

    Runs on ``device`` (``cuda`` unless ``device="cpu"``; with no GPU it
    raises).
    """
    from optuna_tpu_torch.study._study_direction import StudyDirection

    if n_trials < 1:
        raise ValueError(f"n_trials must be >= 1; got {n_trials}.")
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1; got {sync_every}.")
    if n_startup_trials < 1:
        raise ValueError(f"n_startup_trials must be >= 1; got {n_startup_trials}.")
    if len(study.directions) != 1:
        raise ValueError("optimize_scan supports single-objective studies only.")
    _validate_space(objective.search_space)
    device = resolve_device(device)
    if study._thread_local.in_optimize_loop:
        raise RuntimeError("Nested invocation of `optimize_scan` isn't allowed.")

    # The live large-n thresholds, re-read at every chunk boundary.
    control = {
        "n_exact_max": N_EXACT_MAX if n_exact_max is None else int(n_exact_max),
        "n_inducing": N_INDUCING_MAX if n_inducing is None else int(n_inducing),
    }
    study._scan_gp_control = control
    study._stop_flag = False
    study._thread_local.in_optimize_loop = True
    # Attach the reporter and the autopilot at the loop's entry (no-ops
    # unless opted in): the scan loop's actuator is ``_scan_gp_control``.
    health.attach(study)
    autopilot.attach(study)
    try:
        with _tracing.maybe_trace_from_env():
            _run_scan(
                study,
                objective,
                n_trials,
                sync_every=sync_every,
                n_startup_trials=n_startup_trials,
                seed=seed,
                minimum_noise=1e-7 if deterministic_objective else 1e-5,
                callbacks=list(callbacks or ()),
                n_preliminary_samples=n_preliminary_samples,
                n_local_search=n_local_search,
                lbfgs_iters=lbfgs_iters,
                maximize=study.direction == StudyDirection.MAXIMIZE,
                control=control,
                device=device,
                resume=resume,
            )
    finally:
        study._thread_local.in_optimize_loop = False
        health.flush(study)


def _grown(buf: torch.Tensor, size: int) -> torch.Tensor:
    """``buf`` copied (device to device) into a zero buffer of ``size`` rows."""
    out = torch.zeros((size, *buf.shape[1:]), dtype=buf.dtype, device=buf.device)
    out[: buf.shape[0]] = buf
    return out


def _run_scan(
    study: "Study",
    objective: "VectorizedObjective",
    n_trials: int,
    *,
    sync_every: int,
    n_startup_trials: int,
    seed: int | None,
    minimum_noise: float,
    callbacks: list,
    n_preliminary_samples: int,
    n_local_search: int,
    lbfgs_iters: int,
    maximize: bool,
    control: dict,
    device: torch.device,
    resume: bool = False,
) -> None:
    space_dict = objective.search_space
    space = SearchSpace(space_dict)
    d = space.dim
    dev = _device_space(objective, space, n_preliminary_samples, device)
    rng = np.random.RandomState(seed)
    storage = study._storage

    # Exactly-once bookkeeping: a resume classifies the history's op tokens
    # and validates the newest checkpoint; a fresh run claims the next run
    # id, so its op tokens never collide with an earlier incarnation's.
    told = 0
    resume_state = None
    ledger: _ResumeLedger | None = None
    if resume:
        with telemetry.span("ckpt.restore"), flight.span("ckpt.restore"):
            resume_state, ledger, run_id, told = _restore_scan(
                study, space_dict, sync_every=sync_every
            )
    else:
        run_id = _ckpt.synced_ops(study._get_trials(deepcopy=False, use_cache=True)).max_run_id + 1
    ckpt_seq = _ckpt.max_slot_seq(storage, study._study_id, "scan") + 1

    if resume_state is None:
        # Start from any COMPLETE history over this space, direction-applied
        # and clipped to the f32-safe score.
        prior = [
            t
            for t in study._get_trials(deepcopy=False, states=(TrialState.COMPLETE,), use_cache=True)
            if all(p in t.params for p in space_dict)
        ]
        if prior:
            X_hist = space.normalize([t.params for t in prior]).astype(np.float32)
            vals = np.asarray([t.value for t in prior])
            scores = _clip_scores(vals if maximize else -vals)
        else:
            X_hist = np.zeros((0, d), dtype=np.float32)
            scores = np.zeros((0,), dtype=np.float32)

        # -------------------------------------------------- random startup
        n_startup = max(0, min(n_startup_trials - len(prior), n_trials - told))
        if n_startup:
            x0 = space.sample_normalized(n_startup, seed=int(rng.randint(0, 2**31 - 1))).astype(np.float32)
            startup = _startup_program(objective, space)
            with torch.profiler.record_function(_TRACE_DISPATCH), telemetry.span("dispatch"), \
                    flight.span("dispatch"):
                vals0, fins0 = startup(torch.as_tensor(x0, device=device))
                vals0 = vals0.cpu().numpy()
                fins0 = fins0.cpu().numpy()
            _sync_results(
                study, space, space_dict, x0, vals0, fins0, callbacks,
                ops=[_ckpt.op_token(run_id, "s", i) for i in range(n_startup)],
                ledger=ledger,
            )
            told += n_startup
            keep = fins0
            if keep.any():
                X_hist = np.concatenate([X_hist, x0[keep]])
                scores = np.concatenate([scores, _clip_scores(vals0[keep] if maximize else -vals0[keep])])
            if study._stop_flag or told >= n_trials:
                return

        # -------------------------------------------- device bucket setup
        n_hist = len(X_hist)
        bucket = _bucket(n_hist + sync_every)
        Xb = torch.zeros((bucket, d), dtype=torch.float32, device=device)
        yb = torch.zeros((bucket,), dtype=torch.float32, device=device)
        mb = torch.zeros((bucket,), dtype=torch.float32, device=device)
        if n_hist:
            Xb[:n_hist] = torch.as_tensor(X_hist, device=device)
            yb[:n_hist] = torch.as_tensor(scores, device=device)
            mb[:n_hist] = 1.0
        n_dev = n_hist
        n_upper = n_hist  # bound on the cursor (quarantines may lag it)
        key_seed = int(rng.randint(0, 2**31 - 1))
        warm_raw = None  # the previous chunk's fitted raw params
        chunk_idx = 0
        Zb = zyb = zmb = None  # inducing buffers, once the history first goes sparse
        m_pad = 0
    else:
        # --------------------------------------- carry restore (checkpoint)
        # Rebuild the loop-top state the dead process stashed: the
        # interrupted chunk re-runs on the same buffers, bucket, inducing
        # set and draws, so its re-told slots are the dead run's slots and
        # the ledger can skip them.
        st = resume_state

        def _on_device(a):
            return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)

        bucket = int(st["bucket"])
        Xb, yb, mb = _on_device(st["X"]), _on_device(st["y"]), _on_device(st["m"])
        n_dev = int(st["n_dev"])
        n_upper = int(st["n_upper"])
        key_seed = int(st["key_seed"])
        warm_raw = _on_device(st["warm_raw"])
        chunk_idx = int(st["chunk_idx"])
        rng.set_state(st["rng_state"])
        m_pad = int(st["m_pad"])
        Zb, zyb, zmb = _on_device(st["Z"]), _on_device(st["zy"]), _on_device(st["zm"])
        if told >= n_trials:
            return

    default_start = np.zeros(d + 2, dtype=np.float32)
    default_start[d + 1] = np.log(1e-2)
    n_cand = _N_INCUMBENTS + dev.sobol_base.shape[0]
    pending: tuple | None = None  # (chunk, n_tell, ops, n_new)

    def _stash_carry() -> dict:
        """The loop-top carry as a checkpointable dict, captured before this
        iteration changes anything (bucket growth, RNG draws, inducing
        reseed, chunk index): the state that re-dispatches chunk
        ``chunk_idx``. The chunk programs never write their input tensors,
        so the stash holds references; :func:`_write_scan_checkpoint`
        realizes them once the previous chunk's tells are synced."""
        return {
            "param_names": tuple(space_dict),
            "sync_every": int(sync_every),
            "run_id": int(run_id),
            "bucket": int(bucket),
            "n_upper": int(n_upper),
            "chunk_idx": int(chunk_idx),
            "key_seed": int(key_seed),
            "rng_state": rng.get_state(),
            "X": Xb,
            "y": yb,
            "m": mb,
            "n_dev": int(n_dev),
            "warm_raw": warm_raw,
            "Z": Zb,
            "zy": zyb,
            "zm": zmb,
            "m_pad": int(m_pad),
        }

    # First durable point: a death during chunk 0 or 1 (before the first
    # chunk-sync write) restores from here instead of falling back.
    _write_scan_checkpoint(storage, study._study_id, _stash_carry(), told=told, seq=ckpt_seq)
    ckpt_seq += 1
    dup_counts = ledger.dup_counts if ledger is not None else {}
    remaining = n_trials - told
    while remaining > 0 and not study._stop_flag:
        # The loop-top carry, durable once this iteration syncs the pending
        # chunk.
        carry_stash = _stash_carry()
        if n_upper + sync_every > bucket:
            # Bucket crossing: copy the buffers into the next power of two.
            bucket = _bucket(n_upper + sync_every)
            Xb, yb, mb = _grown(Xb, bucket), _grown(yb, bucket), _grown(mb, bucket)
        if warm_raw is None:
            n_starts, fit_iters = _SCAN_COLD_FIT
            starts_np = [default_start]
            while len(starts_np) < n_starts:
                starts_np.append((default_start + rng.normal(0, 1.0, size=d + 2)).astype(np.float32))
            starts = torch.as_tensor(np.stack(starts_np), device=device)
        else:
            n_starts, fit_iters = _SCAN_WARM_FIT
            starts = torch.stack([torch.as_tensor(default_start, device=device), warm_raw])
        program_kwargs = dict(
            fit_iters=fit_iters, minimum_noise=minimum_noise, maximize=maximize,
            n_local_search=n_local_search, lbfgs_iters=lbfgs_iters,
        )
        # Large-n routing: re-read the live thresholds every chunk.
        sparse = n_upper + sync_every > max(1, int(control["n_exact_max"]))
        if sparse:
            m_eff = max(1, min(int(control["n_inducing"]), n_upper))
            m_pad_want = min(_pow2_bucket(m_eff), bucket)
            if Zb is None or m_pad_want != m_pad:
                # First sparse chunk (or the capacity changed): seed the
                # inducing set by farthest-point over the live history.
                m_pad = m_pad_want
                Zb, zyb, zmb = _seed_inducing_program(m_pad)(Xb, yb, mb)
        shifts, gumbels = _chunk_draws(key_seed, chunk_idx, sync_every, d, n_cand, device)
        this_chunk = chunk_idx
        chunk_idx += 1
        # Run chunk k+1, THEN sync chunk k: a stop() from chunk k's callbacks
        # discards chunk k+1 before any of its trials exist.
        with torch.profiler.record_function(_TRACE_CHUNK), telemetry.span("scan.chunk"), \
                flight.span("scan.chunk"):
            if sparse:
                out = _chunk_program_sparse(objective, space, dev, **program_kwargs)(
                    starts, Xb, yb, mb, n_dev, Zb, zyb, zmb, shifts, gumbels
                )
                Zb, zyb, zmb = out.Z, out.zy, out.zmask
            else:
                out = _chunk_program(objective, space, dev, **program_kwargs)(
                    starts, Xb, yb, mb, n_dev, shifts, gumbels
                )
        Xb, yb, mb, n_dev, warm_raw = out.X, out.y, out.mask, out.n, out.raw
        n_upper += sync_every
        # Budget algebra with resume dups: ops of this chunk the dead run
        # already told re-run with the same draws but are skipped at tell
        # time, so they ride inside n_tell without consuming new budget.
        dups = dup_counts.pop(this_chunk, 0) if dup_counts else 0
        n_tell = min(sync_every, remaining + dups)
        remaining -= n_tell - dups
        if pending is not None:
            _sync_chunk(study, space, space_dict, pending, callbacks, ledger)
            told += pending[3]
            if study._stop_flag:
                return
            # The pending chunk's tells are durable: persist the loop-top
            # stash (the state that re-dispatches this iteration's chunk).
            _write_scan_checkpoint(storage, study._study_id, carry_stash, told=told, seq=ckpt_seq)
            ckpt_seq += 1
        pending = (
            out, n_tell, [_ckpt.op_token(run_id, this_chunk, i) for i in range(n_tell)], n_tell - dups
        )

    if pending is not None and not study._stop_flag:
        exit_stash = _stash_carry()
        _sync_chunk(study, space, space_dict, pending, callbacks, ledger)
        told += pending[3]
        if not study._stop_flag:
            # Terminal checkpoint: a resume of a finished study restores
            # this, finds the budget spent and returns without a chunk.
            _write_scan_checkpoint(storage, study._study_id, exit_stash, told=told, seq=ckpt_seq)


def _sync_chunk(study, space, space_dict, pending, callbacks, ledger=None) -> None:
    """Read one finished chunk back to the host, publish its device stats
    and commit its trials."""
    out, n_tell, ops, _n_new = pending
    with torch.profiler.record_function(_TRACE_SYNC), telemetry.span("scan.sync"), flight.span("scan.sync"):
        xs_np = out.xs[:n_tell].cpu().numpy()
        vals_np = out.vals[:n_tell].cpu().numpy()
        _publish_chunk(out.stats)
        _sync_results(
            study, space, space_dict, xs_np, vals_np, out.finites[:n_tell], callbacks,
            ops=ops, ledger=ledger,
        )


def _sync_results(study, space, space_dict, xs, vals, fins, callbacks, *, ops, ledger=None) -> None:
    """Commit one chunk's results: create the trials (one storage batch),
    stamp each with its op token, pin its params to the evaluated point and
    tell COMPLETE/FAIL: the logical end state the per-trial path leaves. A
    mid-loop error (or ``Study.stop()`` from a callback) fails the
    not-yet-told remainder instead of stranding it RUNNING.

    On a resumed re-run chunk ``ledger`` filters the slots: ops the dead run
    already told are skipped (never re-told, no new trial row), and its
    token-stamped RUNNING strays are adopted: told into the existing trial
    instead of a duplicate."""
    if len(xs) == 0:
        return
    storage = study._storage
    # Plan each slot before touching storage: (slot index, token, adopted
    # trial id or None). Already-told ops drop out of the plan.
    plan = []
    for i in range(len(xs)):
        token = ops[i]
        if ledger is not None:
            if token in ledger.told:
                continue
            plan.append((i, token, ledger.running.pop(token, None)))
        else:
            plan.append((i, token, None))
    if not plan:
        return
    n_new = sum(1 for _, _, tid in plan if tid is None)
    new_ids = iter(storage.create_new_trials(study._study_id, n_new) if n_new else ())
    study._thread_local.cached_all_trials = None
    trials = [Trial(study, tid if tid is not None else next(new_ids)) for _, _, tid in plan]
    j = 0
    try:
        for j, trial in enumerate(trials):
            if study._stop_flag:
                break
            i, token, _adopted = plan[j]
            # Token before tell: a death in between leaves a token-stamped
            # RUNNING stray a resume adopts; a death before leaves a
            # tokenless stray a resume reaps.
            storage.set_trial_system_attr(trial._trial_id, _ckpt.OP_TOKEN_ATTR, token)
            params = space.unnormalize_one(xs[i])
            # Pin the evaluated point as the trial's relative proposal so
            # _suggest records it under its distributions without touching
            # the (bypassed) sampler.
            trial.relative_search_space = space_dict
            trial.relative_params = params
            for name, dist in space_dict.items():
                trial._suggest(name, dist)
            if flight.enabled():
                flight.trial_event("ask", trial.number)
            if bool(fins[i]):
                frozen = study.tell(trial, float(vals[i]))
            else:
                telemetry.count("executor.quarantine")
                try:
                    storage.set_trial_system_attr(
                        trial._trial_id,
                        "fail_reason",
                        f"non-finite objective value {vals[i]!r} quarantined "
                        "(scan loop, isfinite verdict)",
                    )
                except Exception as err:  # the reason attr is diagnostics; the FAIL tell below must run
                    _logger.warning(
                        f"writing fail_reason for trial {trial.number} raised "
                        f"{err!r}; failing the trial without it."
                    )
                frozen = study.tell(trial, state=TrialState.FAIL)
                _logger.warning(
                    f"Trial {trial.number} failed: non-finite objective value "
                    f"{vals[i]!r} quarantined by the scan loop."
                )
            if flight.enabled():
                flight.trial_event("tell", frozen.number, frozen.state.name)
            for callback in callbacks:
                callback(study, frozen)
        else:
            return
        # Study.stop() mid-chunk: the chunk's remaining created trials must
        # not strand RUNNING (nor COMPLETE past the stop).
        _fail_remaining(
            study, trials[j:], "study stopped (Study.stop()) before this trial was told"
        )
    except Exception:  # a storage error mid-sync must not strand the chunk's trials RUNNING
        _fail_remaining(study, trials[j:], "scan chunk sync aborted before this trial was told")
        raise
    finally:
        # Chunk-boundary health publish and autopilot step, after the
        # chunk's one read-back (module-global checks while off).
        health.maybe_report(study)
        autopilot.maybe_step(study)


class _ResumeLedger:
    """Exactly-once resume bookkeeping, consulted at every chunk sync."""

    __slots__ = ("told", "running", "dup_counts")

    def __init__(self, told, running, dup_counts) -> None:
        #: Op tokens the dead run durably told: never re-told.
        self.told = frozenset(told)
        #: Token -> trial id of the dead run's adoptable RUNNING strays.
        self.running = dict(running)
        #: Chunk index -> told-op count past the checkpoint watermark: the
        #: budget to refund when that chunk is re-dispatched.
        self.dup_counts = dict(dup_counts)


def _restore_scan(study, space_dict, *, sync_every):
    """Resume bookkeeping (trust-but-verify): classify the history's op
    tokens, reap unidentifiable strays, and validate the newest scan
    checkpoint against this study's configuration and synced watermark.

    Returns ``(state, ledger, run_id, told)``. ``state`` is the restored
    carry dict, or None: the caller falls back to its ordinary
    recompute-from-COMPLETE-history warm start (counted
    ``checkpoint.fallback``) under a fresh run id. Either way no
    already-synced op is re-told, and no stray stays RUNNING.
    """
    storage = study._storage
    ops = _ckpt.synced_ops(study.get_trials(deepcopy=False))
    rec = _ckpt.load_checkpoint(
        storage,
        study._study_id,
        "scan",
        synced_told=len(ops.told),
        # The 2-slot ring means the newest *valid* blob can trail the
        # synced history by up to two write intervals (a torn newest slot
        # hands the older slot the win); beyond that it is stale.
        max_lag=2 * sync_every,
    )
    state = rec.state if rec is not None else None
    if state is not None and (
        tuple(state.get("param_names", ())) != tuple(space_dict)
        or int(state.get("sync_every", 0)) != int(sync_every)
    ):
        telemetry.count("checkpoint.rejected")
        _logger.warning(
            "Scan checkpoint was written under a different search space or "
            "sync_every; rejecting it and recomputing from COMPLETE history."
        )
        state = None
    if state is not None:
        run_id = int(state["run_id"])
        chunk_floor = int(state["chunk_idx"])
        # Told ops of this run at or after the restored chunk landed past
        # the watermark: the re-run chunks regenerate them with the same
        # draws, so they are skipped at tell time and refunded at dispatch.
        dup_counts: dict[int, int] = {}
        for token in ops.told:
            parsed = _ckpt.parse_op_token(token)
            if parsed is None or parsed[0] != run_id or parsed[1] is None:
                continue
            if parsed[1] >= chunk_floor:
                dup_counts[parsed[1]] = dup_counts.get(parsed[1], 0) + 1
        told = int(state["told"]) + sum(dup_counts.values())
        adoptable: dict[str, int] = {}
        reap = list(ops.stranded)
        for token, tid in ops.running.items():
            parsed = _ckpt.parse_op_token(token)
            if parsed is not None and parsed[0] == run_id:
                adoptable[token] = tid
            else:
                reap.append(tid)
        ledger = _ResumeLedger(ops.told, adoptable, dup_counts)
        _logger.info(
            f"Resuming scan run {run_id} from checkpoint seq {rec.seq}: "
            f"re-dispatching from chunk {chunk_floor} with {told} tells "
            f"already synced ({sum(dup_counts.values())} past the watermark "
            "will be re-run and skipped, not re-told)."
        )
    else:
        telemetry.count("checkpoint.fallback")
        run_id = ops.max_run_id + 1
        told = len(ops.told)
        reap = list(ops.stranded) + list(ops.running.values())
        ledger = _ResumeLedger(ops.told, {}, {})
        _logger.warning(
            f"No usable scan checkpoint; resuming as run {run_id} via the "
            f"recompute-from-COMPLETE-history path ({told} synced tells "
            "already count against the budget)."
        )
    _reap_strays(
        study, reap, reason="stranded RUNNING stray from a preempted scan run, reaped at resume"
    )
    return state, ledger, run_id, told


def _reap_strays(study, trial_ids, *, reason: str) -> None:
    """FAIL out RUNNING strays a dead process left behind, marked
    ``ckpt:stranded`` so resume budget accounting excludes them."""
    storage = study._storage
    for tid in trial_ids:
        try:
            storage.set_trial_system_attr(tid, _ckpt.STRANDED_ATTR, True)
            storage.set_trial_system_attr(tid, "fail_reason", reason)
            storage.set_trial_state_values(tid, state=TrialState.FAIL)
        except Exception as err:  # reaping is best-effort cleanup; a later resume retries a stray left RUNNING
            _logger.warning(f"reaping stranded trial id {tid} raised {err!r}; continuing.")
    if trial_ids:
        study._thread_local.cached_all_trials = None


def _write_scan_checkpoint(storage, study_id, stash, *, told: int, seq: int) -> None:
    """Persist one loop-top carry stash into the ``ckpt:scan:*`` ring.

    Device tensors are realized to NumPy here, always after the chunk that
    produced them was synced, so no host read lands inside a chunk. The blob
    holds only plain types and NumPy arrays."""
    state = dict(stash)
    state["told"] = int(told)
    for field in ("X", "y", "m", "warm_raw", "Z", "zy", "zm"):
        if state[field] is not None:
            state[field] = state[field].detach().cpu().numpy()
    _ckpt.write_checkpoint(storage, study_id, "scan", state, n_told=told, seq=seq)


def _fail_remaining(study, trials, reason: str) -> None:
    for trial in trials:
        try:
            try:
                study._storage.set_trial_system_attr(trial._trial_id, "fail_reason", reason)
            except UpdateFinishedTrialError:
                raise
            except Exception:  # diagnostics attr; the FAIL tell below is what matters
                pass
            study.tell(trial, state=TrialState.FAIL)
        except UpdateFinishedTrialError:
            continue
        except Exception as err:  # visit every trial: one failed tell must not strand the rest
            _logger.warning(
                f"failing trial {trial.number} raised {err!r}; continuing so "
                "the rest of the chunk is not stranded RUNNING."
            )
