"""WFG exact hypervolume as a fixed-shape explicit-stack loop on the device
(port of ``optuna_tpu/ops/wfg.py``).

The WFG recursion ``HV(S) = sum_i [inc(p_i) - HV(limit_i)]`` with
``limit_i = pareto(max(S[i+1:], p_i))`` unrolls into a signed sum of
inclusive volumes over the recursion tree, which an explicit stack of
fixed-shape frames ``(points (N, M), mask (N,), cursor, sign)`` evaluates
one node at a time. Each node's limit-and-filter step is one launch of
:func:`optuna_tpu_torch.ops.kernels.wfg.limit_and_filter`.

The whole stack lives on the device: ``s_pts (N+2, N, M)``, ``s_msk``,
``s_cur``, ``s_sign`` and the 0-d ``depth`` and ``acc``. The body has no
Python branch on a tensor value and no host read: it is written with
``torch.where`` and index tensors, as the reference's ``lax.while_loop``
body is. At ``depth == 0`` it changes nothing (its writes go to a spare
frame, ``N + 1``). The host reads ``depth`` once every
:data:`NODES_PER_SYNC` bodies, so one hypervolume costs about
``nodes / NODES_PER_SYNC`` host syncs.

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
from optuna_tpu_torch.ops.kernels.wfg import limit_and_filter

#: Stack-machine bodies between two host reads of ``depth``.
NODES_PER_SYNC = 32

#: Counters of the loop since the last reset: ``nodes`` (bodies run at
#: ``depth > 0``), ``bodies`` (all bodies, one kernel step each) and
#: ``syncs`` (host reads of ``depth``). ``nodes`` is read from the device
#: once per hypervolume.
STATS = {"nodes": 0, "bodies": 0, "syncs": 0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def _masked_pareto(pts: torch.Tensor, msk: torch.Tensor) -> torch.Tensor:
    """Non-dominated, deduplicated subset mask among masked rows (minimize).

    Duplicates keep the lowest index; masked-out rows sit at +inf and can
    never dominate.
    """
    n = pts.shape[0]
    eff = torch.where(msk[:, None], pts, torch.inf)
    leq = torch.all(eff[:, None, :] <= eff[None, :, :], dim=2)
    strict = torch.any(eff[:, None, :] < eff[None, :, :], dim=2)
    idx = torch.arange(n, device=pts.device)
    earlier = idx[:, None] < idx[None, :]
    dominated = torch.any(leq & (strict | earlier) & msk[:, None], dim=0)
    return msk & ~dominated


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """(1,) index of the first True of ``mask`` (0 when there is none)."""
    return torch.argmax(mask.to(torch.uint8)).reshape(1)


def _prod_last(x: torch.Tensor) -> torch.Tensor:
    """Product over the last dim, left to right: the same rounding on every
    device, where ``torch.prod``'s reduction order is the backend's."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out * x[..., k]
    return out


def _row(stack: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """``stack[at]`` for a (1,) index tensor, with no host read."""
    return stack.index_select(0, at)[0]


def hypervolume_wfg(
    points: torch.Tensor, reference_point: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Exact hypervolume (0-d tensor) of masked rows of ``points`` (N, M).

    Matches the host oracle (``optuna_tpu_torch.hypervolume.wfg``) to
    float32 accuracy; rows outside the reference point or masked out
    contribute 0.
    """
    n, m = points.shape
    dev = points.device
    ref = reference_point
    inside = torch.all(points < ref[None, :], dim=1)
    msk0 = _masked_pareto(points, mask & inside)
    order = torch.argsort(torch.where(msk0, points[:, 0], torch.inf), stable=True)
    m0 = msk0[order]
    pts0 = torch.where(m0[:, None], points[order], ref[None, :])

    spare = n + 1  # frame that absorbs the writes of a body run at depth 0
    s_pts = torch.zeros((n + 2, n, m), dtype=points.dtype, device=dev)
    s_pts[0] = pts0
    s_msk = torch.zeros((n + 2, n), dtype=torch.bool, device=dev)
    s_msk[0] = m0
    s_cur = torch.zeros((n + 2,), dtype=torch.int64, device=dev)
    s_sign = torch.zeros((n + 2,), dtype=points.dtype, device=dev)
    s_sign[0] = 1.0
    idx = torch.arange(n, device=dev)
    depth = torch.ones((), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=points.dtype, device=dev)
    nodes = torch.zeros((), dtype=torch.int64, device=dev)

    while True:
        for _ in range(NODES_PER_SYNC):
            active = depth > 0
            top = torch.clamp(depth - 1, min=0).reshape(1)
            pts = _row(s_pts, top)
            msk = _row(s_msk, top)
            sign = _row(s_sign, top)
            cur = _row(s_cur, top)
            remaining = msk & (idx >= cur)
            has_more = torch.any(remaining) & active
            nxt = _first_true(remaining)
            p = _row(pts, nxt)

            child_pts, child_msk = limit_and_filter(pts, p, msk & (idx > nxt), ref)
            n_child = torch.sum(child_msk)
            # The pivot's inclusive volume, and a one-point child's, which is
            # folded in place instead of pushed.
            only = _row(child_pts, _first_true(child_msk))
            inc, inc_only = _prod_last(ref - torch.stack([p, only]))
            fold = torch.where(n_child == 1, sign * inc_only, 0.0)
            acc = acc + torch.where(has_more, sign * inc - fold, 0.0)

            do_push = has_more & (n_child > 1)
            s_cur.index_copy_(0, top, torch.where(has_more, nxt + 1, cur.reshape(1)))
            slot = torch.where(active, depth, spare).reshape(1)
            s_pts.index_copy_(0, slot, child_pts[None])
            s_msk.index_copy_(0, slot, (child_msk & do_push)[None])
            s_cur.index_copy_(0, slot, torch.zeros_like(slot))
            s_sign.index_copy_(0, slot, -sign.reshape(1))
            nodes = nodes + active.to(torch.int64)
            depth = torch.where(has_more, depth + do_push.to(torch.int64), depth - active.to(torch.int64))
        STATS["bodies"] += NODES_PER_SYNC
        STATS["syncs"] += 1
        if int(depth) == 0:
            break
    STATS["nodes"] += int(nodes)
    return acc


def wfg_loo_contributions(
    points: torch.Tensor, reference_point: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Exclusive contribution of every masked row via the limit identity.

    ``contrib_i = inc(p_i) - HV(max(S \\ {i}, p_i))`` — one WFG evaluation on
    the already-limited set per point (the IWFG trick), not a difference of
    two full-front hypervolumes. Points run one after another, as the
    reference's ``lax.map``; the front mask is read to the host once, and
    rows off the front (their contribution is 0) run no stack.
    """
    n = points.shape[0]
    ref = reference_point
    inside = mask & torch.all(points < ref[None, :], dim=1)
    front = _masked_pareto(points, inside)
    idx = torch.arange(n, device=points.device)
    out = torch.zeros(n, dtype=points.dtype, device=points.device)
    for i in np.flatnonzero(front.cpu().numpy()).tolist():
        p = points[i]
        limited = torch.maximum(points, p[None, :])
        # All inside points (not just the front): a point dominated only by
        # p_i itself still covers part of p_i's box. The kernel's own Pareto
        # filter prunes whatever is redundant after clamping.
        lmask = inside & (idx != i)
        covered = hypervolume_wfg(limited, ref, lmask)
        out[i] = torch.clamp(_prod_last(ref - p) - covered, min=0.0)
    return out


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
