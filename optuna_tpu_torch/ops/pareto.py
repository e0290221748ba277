"""Non-domination ranking on the device (port of ``optuna_tpu/ops/pareto.py``).

The reference computes the O(N² M) dominance matrix with a Pallas kernel
and peels fronts with a ``lax.while_loop`` in the same jitted function. Here
both run on the card in two kernel launches per ranking, whatever the
number of fronts (:func:`optuna_tpu_torch.ops.kernels.nds.rank_fronts`),
with no host read before the caller's. CPU tensors take the plain torch
loop, :func:`non_domination_rank_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.ops.kernels.nds import TILE as _TILE
from optuna_tpu_torch.ops.kernels.nds import rank_fronts, rank_fronts_plain


def non_domination_rank(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Ranks (0 = Pareto front) for masked rows; padded rows get ``N + 1``.

    ``values`` (N, M) float32, minimisation-normalised; ``mask`` (N,) 1.0 for
    real rows. Returns (N,) int32 on ``values.device``: the ranking kernels
    for CUDA tensors, :func:`non_domination_rank_plain` for CPU tensors.
    """
    return rank_fronts(values, mask.to(torch.float32))[: values.shape[0]]


def non_domination_rank_plain(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`non_domination_rank` as a loop of torch ops on any device: the
    CPU route, and the check of the kernels on the card."""
    return rank_fronts_plain(values, mask)[: values.shape[0]]


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
