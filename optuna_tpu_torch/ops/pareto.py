"""Non-domination ranking on the device: the dominance kernel plus a peeling
loop of torch ops (port of ``optuna_tpu/ops/pareto.py``).

The O(N² M) dominance comparisons run as one launch of
:func:`optuna_tpu_torch.ops.kernels.nds.dominance_matrix`; the
O(front-count) peeling loop, a ``lax.while_loop`` in the reference, is a
loop of torch ops that stays on the device. The host reads whether any row
remains once every :data:`FRONTS_PER_SYNC` fronts; a front step with no row
left changes nothing, so the extra steps are harmless.
"""

from __future__ import annotations

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.ops.kernels.nds import TILE as _TILE
from optuna_tpu_torch.ops.kernels.nds import dominance_matrix

#: Front steps between two host checks of the peeling loop.
FRONTS_PER_SYNC = 8


def non_domination_rank(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Ranks (0 = Pareto front) for masked rows; padded rows get ``N + 1``.

    ``values`` (N, M) float32, minimisation-normalised; ``mask`` (N,) 1.0 for
    real rows. Returns (N,) int32 on ``values.device``.
    """
    n = values.shape[0]
    mask = mask.to(torch.float32)
    dom = dominance_matrix(values) * mask[:, None] * mask[None, :]
    ranks = torch.full((n,), n + 1, dtype=torch.int32, device=values.device)
    remaining = mask.clone()
    r = 0
    while True:
        for _ in range(FRONTS_PER_SYNC):
            dominated = torch.any((dom * remaining[:, None]) > 0, dim=0)
            front = (remaining > 0) & ~dominated
            ranks = torch.where(front, r, ranks)
            remaining = torch.where(front, 0.0, remaining)
            r += 1
        if not bool(torch.any(remaining > 0)):
            return ranks


def non_domination_rank_np(values: np.ndarray, *, device=None) -> np.ndarray:
    """Host entry: ordinal-transform, pad to the tile multiple, rank on ``device``.

    Dominance depends only on each objective's ORDER (ties included), so every
    column is replaced by its dense rank (0..n_unique-1) before the f32 kernel
    — exact for any float64 input (overflow, inf, sub-eps gaps included),
    since ordinals are small integers representable exactly in f32.
    """
    dev = resolve_device(device)
    n, m = values.shape
    ordinals = np.empty((n, m), dtype=np.float32)
    for j in range(m):
        _, inverse = np.unique(values[:, j], return_inverse=True)  # +inf sorts last
        ordinals[:, j] = inverse.reshape(-1)
    n_pad = ((n + _TILE - 1) // _TILE) * _TILE
    vp = np.full((n_pad, m), np.float32(n_pad + 1), dtype=np.float32)
    vp[:n] = ordinals
    mask = np.zeros(n_pad, dtype=np.float32)
    mask[:n] = 1.0
    ranks = non_domination_rank(torch.as_tensor(vp, device=dev), torch.as_tensor(mask, device=dev))
    return ranks.cpu().numpy()[:n].astype(np.int64)
