"""Greedy hypervolume subset selection (HSSP).

Parity target: ``optuna/_hypervolume/hssp.py:45,143`` — lazy-greedy selection
of the k-point subset approximately maximizing hypervolume ((1-1/e)-optimal
since HV is submodular). Contributions are kept in a max-heap and only
re-evaluated when stale (the "lazy" trick).
"""

from __future__ import annotations

import heapq

import numpy as np

from optuna_tpu_torch.hypervolume.wfg import compute_hypervolume


def solve_hssp(
    rank_i_loss_vals: np.ndarray,
    reference_point: np.ndarray,
    subset_size: int,
) -> np.ndarray:
    """Indices (into ``rank_i_loss_vals``) of the selected subset."""
    n = len(rank_i_loss_vals)
    if subset_size >= n:
        return np.arange(n)
    if subset_size <= 0:
        return np.arange(0)

    selected: list[int] = []
    selected_vals: list[np.ndarray] = []
    hv_selected = 0.0

    # Lazy greedy: heap of (-contribution, stale_stamp, index).
    contribs = [
        compute_hypervolume(rank_i_loss_vals[i : i + 1], reference_point)
        for i in range(n)
    ]
    heap = [(-c, 0, i) for i, c in enumerate(contribs)]
    heapq.heapify(heap)
    stamp = 0

    while len(selected) < subset_size and heap:
        neg_c, s, i = heapq.heappop(heap)
        if i in selected:
            continue
        if s < stamp:
            # Stale: recompute this point's marginal contribution.
            cand = np.vstack(selected_vals + [rank_i_loss_vals[i]])
            c = compute_hypervolume(cand, reference_point) - hv_selected
            heapq.heappush(heap, (-c, stamp, i))
            continue
        selected.append(i)
        selected_vals.append(rank_i_loss_vals[i])
        hv_selected = compute_hypervolume(np.vstack(selected_vals), reference_point)
        stamp += 1

    return np.asarray(selected, dtype=np.int64)
