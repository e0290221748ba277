"""WFG exact hypervolume through an explicit stack of fixed-shape frames
(port of ``optuna_tpu/ops/wfg.py``).

The WFG recursion ``HV(S) = sum_i [inc(p_i) - HV(limit_i)]`` with
``limit_i = pareto(max(S[i+1:], p_i))`` unrolls into a signed sum of
inclusive volumes over the recursion tree, which an explicit stack of
fixed-shape frames ``(points (N, M), mask (N,), cursor, sign)`` evaluates
one node at a time. This module prepares the root frames in torch ops (the
inside mask, the Pareto filter, the sort) and hands them to
:func:`optuna_tpu_torch.ops.kernels.wfg.wfg_stack`, which runs every stack
to its end: on the card in one kernel launch, one thread block per frame;
on the CPU in the plain torch loop.

Key fixed-shape properties (as in the reference):

* depth is bounded by N (each child's cursor set strictly shrinks);
* the root is sorted once, ascending in objective 0; ``max(pts, p)`` with
  ``p`` drawn from earlier in the order preserves that sort for every child;
* single-point children fold directly into the accumulator.

Inputs are expected in the unit box (the wrappers in
:mod:`optuna_tpu_torch.hypervolume` normalise per coordinate, which is
volume-exact), keeping float32 products well-scaled.
"""

from __future__ import annotations

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.ops.kernels.wfg import NODES_PER_SYNC, STATS, _prod_last, reset_stats, wfg_stack

__all__ = [
    "NODES_PER_SYNC", "STATS", "hypervolume_wfg", "hypervolume_wfg_nd", "reset_stats",
    "wfg_loo_contributions", "wfg_loo_nd",
]

#: Elements of the (B, N, N, M) compare blocks of one batched prelude step.
_PRELUDE_ELEMENTS = 1 << 26


def _masked_pareto(pts: torch.Tensor, msk: torch.Tensor) -> torch.Tensor:
    """Non-dominated, deduplicated subset mask among masked rows (minimize),
    over the last two dims of ``pts`` (..., N, M).

    Duplicates keep the lowest index; masked-out rows sit at +inf and can
    never dominate.
    """
    n = pts.shape[-2]
    eff = torch.where(msk[..., None], pts, torch.inf)
    leq = torch.all(eff[..., :, None, :] <= eff[..., None, :, :], dim=-1)
    strict = torch.any(eff[..., :, None, :] < eff[..., None, :, :], dim=-1)
    idx = torch.arange(n, device=pts.device)
    earlier = idx[:, None] < idx[None, :]
    dominated = torch.any(leq & (strict | earlier) & msk[..., :, None], dim=-2)
    return msk & ~dominated


def _roots(points: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Root frames of (B, N, M) ``points``: ``(pts0, m0)`` with the inside,
    non-dominated rows first, ascending in objective 0 (stable), and the
    other rows at ``ref``. Compares and selects only, so batching is exact."""
    b, n, m = points.shape
    step = max(1, _PRELUDE_ELEMENTS // (n * n * m))
    pts0, m0 = [], []
    for lo in range(0, b, step):
        pts = points[lo : lo + step]
        inside = torch.all(pts < ref, dim=-1)
        msk0 = _masked_pareto(pts, mask[lo : lo + step] & inside)
        order = torch.argsort(torch.where(msk0, pts[..., 0], torch.inf), dim=-1, stable=True)
        ordered = torch.gather(msk0, 1, order)
        pts0.append(torch.where(ordered[..., None], torch.gather(pts, 1, order[..., None].expand(-1, -1, m)), ref))
        m0.append(ordered)
    return torch.cat(pts0).contiguous(), torch.cat(m0).contiguous()


def hypervolume_wfg(
    points: torch.Tensor, reference_point: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Exact hypervolume (0-d tensor) of masked rows of ``points`` (N, M).

    Matches the host oracle (``optuna_tpu_torch.hypervolume.wfg``) to
    float32 accuracy; rows outside the reference point or masked out
    contribute 0. One :func:`wfg_stack` call with B = 1.
    """
    ref = reference_point.contiguous()
    pts0, m0 = _roots(points[None], ref, mask[None])
    acc, _ = wfg_stack(pts0, m0, ref)
    return acc[0]


def wfg_loo_contributions(
    points: torch.Tensor, reference_point: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Exclusive contribution of every masked row via the limit identity.

    ``contrib_i = inc(p_i) - HV(max(S \\ {i}, p_i))`` — one WFG evaluation on
    the already-limited set per point (the IWFG trick), not a difference of
    two full-front hypervolumes. Every row's limited frame is prepared in
    one batch and all of them run in one :func:`wfg_stack` call, as the
    reference's ``lax.map`` runs them one after another. A row off the front
    (its contribution is 0) gets an empty frame, which ends at its first
    node.
    """
    n = points.shape[0]
    ref = reference_point.contiguous()
    inside = mask & torch.all(points < ref[None, :], dim=1)
    front = _masked_pareto(points, inside)
    idx = torch.arange(n, device=points.device)
    limited = torch.maximum(points[None, :, :], points[:, None, :])
    # All inside points (not just the front): a point dominated only by p_i
    # itself still covers part of p_i's box. The kernel's own Pareto filter
    # prunes whatever is redundant after clamping.
    lmask = inside[None, :] & (idx[None, :] != idx[:, None]) & front[:, None]
    pts0, m0 = _roots(limited, ref, lmask)
    covered, _ = wfg_stack(pts0, m0, ref)
    return torch.where(front, torch.clamp(_prod_last(ref - points) - covered, min=0.0), 0.0)


def _pad_bucket(n: int) -> int:
    return max(16, 1 << max(0, (n - 1)).bit_length())


def _padded(points: np.ndarray, reference_point: np.ndarray, device: torch.device):
    n = len(points)
    n_pad = _pad_bucket(n)
    pts = np.full((n_pad, points.shape[1]), np.asarray(reference_point), np.float32)
    pts[:n] = points
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    return torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device)


def hypervolume_wfg_nd(points: np.ndarray, reference_point: np.ndarray, *, device=None) -> float:
    """Host entry: exact hypervolume via the WFG stack on ``device`` (N bucketed)."""
    dev = resolve_device(device)
    pts, mask = _padded(points, reference_point, dev)
    ref = torch.as_tensor(np.asarray(reference_point, np.float32), device=dev)
    return float(hypervolume_wfg(pts, ref, mask))


def wfg_loo_nd(points: np.ndarray, reference_point: np.ndarray, *, device=None) -> np.ndarray:
    """Host entry: leave-one-out exclusive contributions via the WFG stack."""
    dev = resolve_device(device)
    pts, mask = _padded(points, reference_point, dev)
    ref = torch.as_tensor(np.asarray(reference_point, np.float32), device=dev)
    out = wfg_loo_contributions(pts, ref, mask)
    return out.cpu().numpy()[: len(points)]
