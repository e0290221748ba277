"""Device-side exact hypervolume: the 2-D fast paths, the N-D slicing
engine and the greedy HSSP (port of ``optuna_tpu/ops/hypervolume.py``).

The N-D engine is the reference's **objective-sweep slicing decomposition
with masked prefix scans**, in torch ops (the reference's is plain jnp, no
Pallas):

* sort once per level by the leading objective (full set, mask-independent;
  stable, as ``jnp.argsort`` is, so ties telescope in the same order);
* the M-D volume is ``sum_i (ref_0 - v_i0) * (A_i - A_{i-1})`` by Abel
  summation of the slab integral, where ``A_i`` is the (M-1)-D hypervolume
  of the i-prefix — every prefix is just a *mask* over one sorted layout;
* the 2-D base case is an O(N) cummin scan that tolerates masked-out rows
  pushed to the reference point.

Every function here takes a batch of frames, (P, N, M) points with (P, N)
masks: the reference's ``vmap``. The M = 3 level is one batched scan over
the (P, N, N) prefix masks. The levels above it loop over their prefixes,
as the reference's ``lax.map`` does, a chunk of prefixes at a time so that
no level holds more than :data:`_SLICE_ELEMENTS` elements: no (N, N, N)
tensor is built.

The greedy HSSP scores every candidate's joint hypervolume with the current
selection, one batched call a step: the slicing engine below
:data:`WFG_MIN_OBJECTIVES`, the WFG stack (K3, one ``wfg_stack`` launch a
step on the card) at and above it.
"""

from __future__ import annotations

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device

#: Objective count at which HSSP scoring switches from the slicing
#: decomposition to the WFG stack (:mod:`optuna_tpu_torch.ops.wfg`): slicing
#: is O(k^{M-1}) per candidate, the stack independent of that exponent. The
#: reference's constant (``optuna_tpu/ops/hypervolume.py:51``), kept: the
#: boundary changes no result, only the time (three-way parity at M = 4 and
#: 5 in ``tests/test_torch_hypervolume.py``).
WFG_MIN_OBJECTIVES = 5

#: Elements of the (P, N, N) prefix masks one slicing level may hold.
_SLICE_ELEMENTS = 1 << 24


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


# ------------------------------------------------------------------ N-D exact


def _hv2_scan(a, b, ref_a, ref_b, m):
    """Masked 2-D hypervolume over the last dim, ``a`` ascending over the
    FULL set. Masked-out rows are pushed to the reference point: zero width,
    and their second coordinate (== ref_b) never lowers the running minimum."""
    x = torch.where(m, a, ref_a)
    y = torch.where(m, b, ref_b)
    y_cummin_prev = torch.cat([ref_b.expand(y.shape[:-1] + (1,)), _cummin(y)[..., :-1]], dim=-1)
    height = y_cummin_prev - torch.minimum(y, y_cummin_prev)
    width = torch.clamp(ref_a - x, min=0.0)
    return torch.sum(width * height, dim=-1)


def _take_rows(points: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``points[p, order[p]]`` for (P, N, M) points and a (P, N) order."""
    return torch.gather(points, 1, order[..., None].expand(-1, -1, points.shape[-1]))


def _hv_sliced(points: torch.Tensor, ref: torch.Tensor, m: torch.Tensor, d: int) -> torch.Tensor:
    """Exact hypervolume (P,) of the masked rows of each (N, M) frame of
    ``points`` (P, N, M) over objectives ``d..M-1``.

    Abel-summed slab decomposition: with rows sorted by objective ``d`` and
    ``A_i`` the (M-1)-D hypervolume of the masked i-prefix,
    ``HV = sum_i masked_i * (ref_d - v_id) * (A_i - A_{i-1})``. Unmasked rows
    have ``A_i == A_{i-1}`` and drop out; ties in objective ``d`` telescope.
    """
    p, n, total_m = points.shape
    rem = total_m - d
    if rem == 1:
        vals = torch.where(m, points[..., d], ref[d])
        return torch.clamp(ref[d] - vals.min(dim=-1).values, min=0.0)
    if rem >= 3 and p > 1 and p * n * n > _SLICE_ELEMENTS:
        step = max(1, _SLICE_ELEMENTS // (n * n))
        return torch.cat([_hv_sliced(points[lo : lo + step], ref, m[lo : lo + step], d) for lo in range(0, p, step)])
    order = torch.argsort(points[..., d], dim=-1, stable=True)
    ps, ms = _take_rows(points, order), torch.gather(m, 1, order)
    if rem == 2:
        return _hv2_scan(ps[..., d], ps[..., d + 1], ref[d], ref[d + 1], ms)
    tril = torch.ones((n, n), dtype=torch.bool, device=points.device).tril()
    prefix = tril[None] & ms[:, None, :]  # (P, N, N): row i masks the i-prefix
    if rem == 3:
        # One shared sort by the next objective; every prefix is a mask.
        sub_order = torch.argsort(ps[..., d + 1], dim=-1, stable=True)
        a = torch.gather(ps[..., d + 1], 1, sub_order)
        b = torch.gather(ps[..., d + 2], 1, sub_order)
        masks = torch.gather(prefix, 2, sub_order[:, None, :].expand(-1, n, -1))
        sub = _hv2_scan(a[:, None, :], b[:, None, :], ref[d + 1], ref[d + 2], masks)
    else:
        # The prefixes one chunk at a time (the reference's lax.map), so a
        # level never holds an (N, N, N) tensor.
        rows = prefix.reshape(p * n, n)
        step = max(1, _SLICE_ELEMENTS // (n * n))
        owner = torch.arange(p * n, device=points.device) // n
        sub = torch.cat([
            _hv_sliced(ps[owner[lo : lo + step]], ref, rows[lo : lo + step], d + 1)
            for lo in range(0, p * n, step)
        ]).reshape(p, n)
    sub_prev = torch.cat([torch.zeros_like(sub[:, :1]), sub[:, :-1]], dim=1)
    width = torch.clamp(ref[d] - ps[..., d], min=0.0)
    return torch.sum(torch.where(ms, width * (sub - sub_prev), 0.0), dim=-1)


def hypervolume_masked(points: torch.Tensor, reference_point: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact hypervolume (minimization) of the masked rows of ``points``:
    (N, M) with an (N,) mask gives a 0-d tensor, (P, N, M) with (P, N) masks
    gives (P,).

    Fixed-shape: dominated rows, duplicates, and rows outside the reference
    point contribute zero without any pre-filtering, so callers can pad
    freely. Matches the host WFG (``optuna_tpu_torch.hypervolume.wfg``) to
    float32 accuracy for any M >= 1.
    """
    single = points.dim() == 2
    pts = points[None] if single else points
    msk = mask[None] if single else mask
    inside = torch.all(pts < reference_point, dim=-1)
    out = _hv_sliced(pts, reference_point, msk & inside, 0)
    return out[0] if single else out


def hypervolume_loo_contributions(
    points: torch.Tensor, reference_point: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Exclusive (leave-one-out) contribution of every masked row, (N,):
    ``contrib_i = HV(S) - HV(S \\ {i})``, the N leave-one-out masks as one
    batch of frames over the same points (the reference's ``lax.map``)."""
    n = points.shape[0]
    total = hypervolume_masked(points, reference_point, mask)
    inside = mask & torch.all(points < reference_point, dim=1)
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    loo = _hv_sliced(points[None].expand(n, -1, -1), reference_point, inside[None] & ~eye, 0)
    return torch.where(mask, torch.clamp(total - loo, min=0.0), 0.0)


def _hssp_greedy(
    points: torch.Tensor, reference_point: torch.Tensor, mask: torch.Tensor, k: int, k_pad: int,
    use_wfg: bool = False,
) -> torch.Tensor:
    """Greedy HSSP: ``k`` steps, each scoring all N candidates' joint
    hypervolume with the current selection (k_pad + 1 points) in one batch,
    and taking the first maximum of the gains. (k_pad,) int64 indices, -1
    past ``k``.

    Plain greedy — the reference's selections (``optuna/_hypervolume/
    hssp.py:45``; laziness only reorders evaluations). Unused selection rows
    sit at the reference point and contribute nothing. ``use_wfg`` scores
    through the WFG stack (:func:`optuna_tpu_torch.ops.wfg.wfg_stack`, one
    launch a step on the card) instead of the slicing engine. No host read
    inside the loop but the stack's one a call.
    """
    from optuna_tpu_torch.ops.wfg import _roots, wfg_stack

    n, m_dim = points.shape
    dev = points.device
    ref = reference_point.contiguous()
    sel = ref.expand(k_pad, m_dim).clone()
    chosen = torch.full((k_pad,), -1, dtype=torch.int64, device=dev)
    avail = mask.clone()
    hv_sel = torch.zeros((), dtype=points.dtype, device=dev)
    all_true = torch.ones((n, k_pad + 1), dtype=torch.bool, device=dev)
    for step in range(k):
        cand = torch.cat([sel[None].expand(n, k_pad, m_dim), points[:, None, :]], dim=1)
        if use_wfg:
            hvs = wfg_stack(*_roots(cand, ref, all_true), ref)[0]
        else:
            hvs = hypervolume_masked(cand, ref, all_true)
        gains = torch.where(avail, hvs - hv_sel, -torch.inf)
        i = torch.argmax(gains).reshape(1)  # the first maximum
        sel[step] = points.index_select(0, i)[0]
        avail.index_fill_(0, i, False)
        chosen[step] = i[0]
        hv_sel = torch.maximum(hvs.index_select(0, i)[0], hv_sel)
    return chosen


def _pad_bucket(n: int) -> int:
    """Power-of-two N bucket (min 32), as the reference pads."""
    return max(32, 1 << max(0, (n - 1)).bit_length())


def _padded(points: np.ndarray, reference_point: np.ndarray, device: torch.device):
    n = len(points)
    n_pad = _pad_bucket(n)
    pts = np.full((n_pad, points.shape[1]), np.asarray(reference_point), np.float32)
    pts[:n] = points
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    return torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device)


def solve_hssp_device(
    points: np.ndarray, reference_point: np.ndarray, subset_size: int, *, device=None
) -> np.ndarray:
    """Host entry for the greedy HSSP on ``device``: the selected indices (k,).

    The scorer follows the objective count: slicing below
    :data:`WFG_MIN_OBJECTIVES`, the WFG stack at or above it. ``k_pad`` is a
    power of two, as the reference's jit bucket is.
    """
    n = len(points)
    k = int(min(subset_size, n))
    if k <= 0:
        return np.arange(0)
    if k >= n:
        return np.arange(n)
    k_pad = 1 << max(0, (k - 1)).bit_length()
    dev = resolve_device(device)
    pts, mask = _padded(points, reference_point, dev)
    ref = torch.as_tensor(np.asarray(reference_point, np.float32), device=dev)
    chosen = _hssp_greedy(pts, ref, mask, k, k_pad, use_wfg=points.shape[1] >= WFG_MIN_OBJECTIVES)
    return chosen.cpu().numpy()[:k].astype(np.int64)


def hypervolume_nd(points: np.ndarray, reference_point: np.ndarray, *, device=None) -> float:
    """Host entry: exact N-D hypervolume on ``device`` (N bucketed, any M)."""
    dev = resolve_device(device)
    pts, mask = _padded(points, reference_point, dev)
    ref = torch.as_tensor(np.asarray(reference_point, np.float32), device=dev)
    return float(hypervolume_masked(pts, ref, mask))


def hypervolume_loo_nd(points: np.ndarray, reference_point: np.ndarray, *, device=None) -> np.ndarray:
    """Host entry: leave-one-out contributions, (len(points),), N bucketed."""
    dev = resolve_device(device)
    pts, mask = _padded(points, reference_point, dev)
    ref = torch.as_tensor(np.asarray(reference_point, np.float32), device=dev)
    return hypervolume_loo_contributions(pts, ref, mask).cpu().numpy()[: len(points)]
