"""Exact hypervolume computation + subset selection (port of
``optuna_tpu/hypervolume/__init__.py``).

Parity target: ``optuna/_hypervolume/`` (2D O(N log N) scan and 3D O(N^2)
cummin trick ``wfg.py:8-39``, ND WFG recursion ``wfg.py:41-107``, greedy HSSP
``hssp.py:45,143``).

Dispatch, with the reference's routing and thresholds: the host NumPy
implementations are authoritative for small inputs; large fronts route to
the device. M >= 5 routes to the WFG stack machine in
:mod:`optuna_tpu_torch.ops.wfg`; the 2-D leave-one-out to
:mod:`optuna_tpu_torch.ops.hypervolume`. The slicing engine behind the
M in {3, 4} routes and the device HSSP is not ported yet (``ROADMAP.md``
A6): those routes raise :class:`NotImplementedError` rather than run on
the host. Every public function takes ``device`` (``None``: the card),
resolved only when a device route is taken.
"""

from __future__ import annotations

import numpy as np

from optuna_tpu_torch.hypervolume.hssp import solve_hssp as _solve_hssp_host
from optuna_tpu_torch.hypervolume.wfg import _pareto_filter
from optuna_tpu_torch.hypervolume.wfg import compute_hypervolume as _compute_hypervolume_host

# Device routing thresholds: the reference's, measured on a TPU
# (``bench_results/mo_crossover.json``). chip_smoke.py prints the card's
# host and device times around them; they are kept until a port benchmark
# re-measures them on the H100.
_DEVICE_MIN_FRONT = {3: 1024, 4: 64}
_DEVICE_MIN_FRONT_WFG = 32  # applies to every M >= 5

_SLICING_TODO = (
    "the hypervolume slicing engine for {what} (optuna_tpu/ops/hypervolume.py) is not "
    "ported yet: ROADMAP.md item A6"
)


def _normalize_for_device(
    front: np.ndarray, reference_point: np.ndarray
) -> tuple[np.ndarray, np.ndarray, float] | None:
    """Affine-map the front into the unit box (in float64, on host) so the
    float32 device kernels never see large magnitudes: raw objective scales
    like 1e12 overflow f32 intermediates (widths multiply across M), while
    per-coordinate scaling is volume-exact — HV_orig = HV_unit * prod(scales).
    Returns None (host fallback) when inputs are not finite-scalable."""
    if not np.isfinite(front).all() or not np.isfinite(reference_point).all():
        return None
    lo = front.min(axis=0)
    scale = reference_point - lo
    if not np.all(scale > 0) or not np.isfinite(scale).all():
        return None
    volume = float(np.prod(scale))
    if not np.isfinite(volume) or volume == 0.0:
        return None
    unit = (front - lo) / scale
    return unit, np.ones_like(reference_point), volume


def compute_hypervolume(
    loss_vals: np.ndarray,
    reference_point: np.ndarray,
    assume_pareto: bool = False,
    *,
    device=None,
) -> float:
    """Hypervolume dominated by ``loss_vals`` w.r.t. ``reference_point``.

    Routed entry (reference ``optuna/_hypervolume/wfg.py:110``): host NumPy
    below the thresholds, the device WFG stack above them at M >= 5.
    """
    loss_vals = np.asarray(loss_vals, dtype=np.float64)
    reference_point = np.asarray(reference_point, dtype=np.float64)
    m = loss_vals.shape[1] if loss_vals.ndim == 2 else 0
    threshold = _DEVICE_MIN_FRONT.get(m)
    if threshold is None and m >= 5:
        threshold = _DEVICE_MIN_FRONT_WFG
    if threshold is not None and len(loss_vals) >= threshold:
        if np.any(np.isnan(loss_vals)):
            raise ValueError("loss_vals must not contain NaN.")
        inside = np.all(loss_vals < reference_point, axis=1)
        front = loss_vals[inside] if assume_pareto else _pareto_filter(loss_vals[inside])
        if len(front) >= threshold:
            norm = _normalize_for_device(front, reference_point)
            if norm is not None:
                unit, unit_ref, volume = norm
                if m >= 5:
                    from optuna_tpu_torch.ops.wfg import hypervolume_wfg_nd

                    return hypervolume_wfg_nd(unit, unit_ref, device=device) * volume
                raise NotImplementedError(_SLICING_TODO.format(what=f"M = {m}"))
        return _compute_hypervolume_host(front, reference_point, assume_pareto=True)
    return _compute_hypervolume_host(loss_vals, reference_point, assume_pareto)


def loo_contributions(
    loss_vals: np.ndarray, reference_point: np.ndarray, *, device=None
) -> np.ndarray:
    """Exclusive (leave-one-out) hypervolume contribution per point, routed.

    The MOTPE below-weights primitive (reference ``_tpe/sampler.py:873``): 2D
    uses the windowed scan, M >= 5 the WFG stack, on the device above their
    thresholds; small inputs fall back to host leave-one-out. Per-coordinate
    normalization scales every contribution by the same ``prod(scale)``,
    which is multiplied back before returning.
    """
    loss_vals = np.asarray(loss_vals, dtype=np.float64)
    reference_point = np.asarray(reference_point, dtype=np.float64)
    n, m = loss_vals.shape
    if m == 2 and n >= 32:
        # Below ~32 points the host O(n log n) scan is microseconds; mirror
        # the M >= 3 thresholds.
        norm = _normalize_for_device(loss_vals, reference_point)
        if norm is not None:
            import torch

            from optuna_tpu_torch._device import resolve_device
            from optuna_tpu_torch.ops.hypervolume import hypervolume_2d_contributions

            dev = resolve_device(device)
            unit, unit_ref, volume = norm
            out = hypervolume_2d_contributions(
                torch.as_tensor(unit, dtype=torch.float32, device=dev),
                torch.as_tensor(unit_ref, dtype=torch.float32, device=dev),
            )
            return np.maximum(out.cpu().numpy().astype(np.float64), 0.0) * volume
    elif (m in (3, 4) and n >= 64) or (m >= 5 and n >= _DEVICE_MIN_FRONT_WFG):
        norm = _normalize_for_device(loss_vals, reference_point)
        if norm is not None:
            unit, unit_ref, volume = norm
            if m >= 5:
                from optuna_tpu_torch.ops.wfg import wfg_loo_nd

                return np.maximum(wfg_loo_nd(unit, unit_ref, device=device), 0.0) * volume
            raise NotImplementedError(_SLICING_TODO.format(what=f"M = {m}"))
    hv_total = _compute_hypervolume_host(loss_vals, reference_point)
    out = np.zeros(n)
    for i in range(n):
        subset = np.delete(loss_vals, i, axis=0)
        hv_wo = _compute_hypervolume_host(subset, reference_point) if len(subset) else 0.0
        out[i] = max(hv_total - hv_wo, 0.0)
    return out


def solve_hssp(
    rank_i_loss_vals: np.ndarray,
    reference_point: np.ndarray,
    subset_size: int,
    *,
    device=None,
) -> np.ndarray:
    """Greedy hypervolume subset selection, routed like
    :func:`compute_hypervolume` (reference ``optuna/_hypervolume/hssp.py:45``).
    ``device`` is kept for the device route, which raises until it is ported."""
    rank_i_loss_vals = np.asarray(rank_i_loss_vals, dtype=np.float64)
    m = rank_i_loss_vals.shape[1] if rank_i_loss_vals.ndim == 2 else 0
    if m >= 3 and len(rank_i_loss_vals) >= 128 and subset_size < len(rank_i_loss_vals):
        norm = _normalize_for_device(rank_i_loss_vals, reference_point)
        if norm is not None:
            raise NotImplementedError(_SLICING_TODO.format(what="the device HSSP"))
    return _solve_hssp_host(rank_i_loss_vals, reference_point, subset_size)


__all__ = ["compute_hypervolume", "loo_contributions", "solve_hssp"]
