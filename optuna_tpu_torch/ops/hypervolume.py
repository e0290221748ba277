"""Device-side exact 2-D hypervolume and its exclusive contributions (port of
``optuna_tpu/ops/hypervolume.py:54-118``).

Only the 2-D functions are ported: they give
:func:`optuna_tpu_torch.hypervolume.loo_contributions` its whole M = 2
route. The slicing engine for M in {3, 4} and the device HSSP are
``ROADMAP.md`` A6 items still to port.
"""

from __future__ import annotations

import torch


def _cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x, dim=-1).values


def hypervolume_2d(points: torch.Tensor, reference_point: torch.Tensor) -> torch.Tensor:
    """Exact 2D hypervolume (minimization) of (..., N, 2) points w.r.t. a
    (..., 2) reference point; leading dims are a batch.

    Dominated/out-of-range points contribute nothing; no pre-filtering needed.
    """
    ref = reference_point
    inside = torch.all(points < ref[..., None, :], dim=-1)
    # Push outsiders to the reference point: zero-area contributions.
    pts = torch.where(inside[..., None], points, ref[..., None, :])
    order = torch.argsort(pts[..., 0], dim=-1, stable=True)
    x = torch.gather(pts[..., 0], -1, order)
    y = torch.gather(pts[..., 1], -1, order)
    # Sweep in ascending x: a point adds area only where its y improves the
    # running minimum of all earlier (smaller-x) points.
    y_cummin_prev = torch.cat([ref[..., 1:2], _cummin(y)[..., :-1]], dim=-1)
    height = torch.clamp(y_cummin_prev - torch.minimum(y, y_cummin_prev), min=0.0)
    width = ref[..., 0:1] - x
    return torch.sum(width * height, dim=-1)


def hypervolume_2d_contributions(
    points: torch.Tensor, reference_point: torch.Tensor
) -> torch.Tensor:
    """Exclusive hypervolume contribution of every point (N,).

    Cancellation-resistant form: a front point's exclusive region lives inside
    its local window ``[x_i, next_front_x) x [y_i, prev_front_min_y)``; the
    contribution is the window area minus the area other (possibly dominated)
    points cover *within that window*. Dominated points and exact duplicates
    contribute 0. The reference's ``vmap`` over points is a batch dimension.
    """
    ref = reference_point
    n = points.shape[0]
    inside = torch.all(points < ref[None, :], dim=1)
    pts = torch.where(inside[:, None], points, ref[None, :])
    # Lexicographic (x, then y) order so duplicates/ties resolve determinately:
    # two stable sorts, the secondary key first.
    by_y = torch.argsort(pts[:, 1], stable=True)
    order = by_y[torch.argsort(pts[by_y, 0], stable=True)]
    x = pts[order, 0]
    y = pts[order, 1]
    sorted_pts = torch.stack([x, y], dim=1)
    y_prev = torch.cat([ref[1:2], _cummin(y)[:-1]])  # prev front min y
    on_front = (y < y_prev) & inside[order]
    # Next front point's x (or ref_x): reverse cummin over x masked to front.
    x_front = torch.where(on_front, x, torch.inf)
    next_front_x = torch.minimum(
        torch.cat([_cummin(x_front.flip(0)).flip(0)[1:], ref[0:1]]), ref[0]
    )

    window_ref = torch.stack([next_front_x, y_prev], dim=1)  # (n, 2)
    # Row i of the batch: every point but i (i sits at its window's corner).
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    others = torch.where(eye[:, :, None], window_ref[:, None, :], sorted_pts[None, :, :])
    covered = hypervolume_2d(others, window_ref)
    window_area = (next_front_x - x) * (y_prev - y)
    contrib_sorted = torch.where(on_front, torch.clamp(window_area - covered, min=0.0), 0.0)
    return torch.zeros(n, dtype=pts.dtype, device=points.device).index_copy(0, order, contrib_sorted)
