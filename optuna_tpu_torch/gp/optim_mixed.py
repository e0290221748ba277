"""Mixed-space helpers of the acquisition maximizer (port of
``optuna_tpu/gp/optim_mixed.py``: ``continuous_bounds``, ``snap_steps`` and
``_sweep_tables``; the multi-dispatch host optimizer waits).
"""

from __future__ import annotations

import numpy as np

from optuna_tpu_torch.gp.search_space import ScaleType, SearchSpace, _round_to_step_grid

_MAX_ENUM_CHOICES = 32
# High-cardinality discrete dims (> _MAX_ENUM_CHOICES grid points) are swept
# over a subsampled grid of this many points, snapped onto true grid
# centers so every proposal stays feasible.
_LINE_SEARCH_POINTS = 64


def continuous_bounds(space: SearchSpace) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cont_mask, lower, upper) in the normalized mixed space."""
    cont_mask = (~np.asarray(space.is_categorical)).astype(np.float64)
    lower = np.zeros(space.dim)
    upper = np.where(space.is_categorical, space.n_choices.astype(np.float64) - 1.0, 1.0)
    return cont_mask, lower, upper


def snap_steps(space: SearchSpace, x: np.ndarray) -> np.ndarray:
    """Snap stepped numerical dims of one normalized point onto grid centers."""
    x = np.array(x, dtype=np.float64)
    for i in range(space.dim):
        if space.scale_types[i] != ScaleType.CATEGORICAL and space.steps[i] > 0:
            x[i] = float(_round_to_step_grid(np.asarray([x[i]]), space.steps[i])[0])
    return x


def _sweep_tables(space: SearchSpace) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Build (dim_onehot, choice_grid, choice_valid) for discrete dims.

    Low-cardinality dims enumerate every grid point; high-cardinality ones
    get a ``_LINE_SEARCH_POINTS``-point subgrid snapped onto grid centers."""
    dims: list[int] = []
    grids: list[np.ndarray] = []
    for i in range(space.dim):
        if space.scale_types[i] == ScaleType.CATEGORICAL:
            dims.append(i)
            grids.append(np.arange(space.n_choices[i], dtype=np.float64))
        elif space.steps[i] > 0:
            n = int(round(1.0 / space.steps[i]))
            dims.append(i)
            if n <= _MAX_ENUM_CHOICES:
                grids.append(space.steps[i] * (np.arange(n) + 0.5))
            else:
                probe = np.linspace(0.0, 1.0, _LINE_SEARCH_POINTS)
                s = space.steps[i]
                snapped = np.clip(_round_to_step_grid(probe, s), 0.5 * s, (n - 0.5) * s)
                grids.append(np.unique(snapped))
    if not dims:
        return None
    Cmax = max(len(g) for g in grids)
    grid = np.zeros((len(dims), Cmax))
    valid = np.zeros((len(dims), Cmax), dtype=bool)
    for j, g in enumerate(grids):
        grid[j, : len(g)] = g
        valid[j, : len(g)] = True
    onehot = np.zeros((len(dims), space.dim))
    onehot[np.arange(len(dims)), dims] = 1.0
    return onehot, grid, valid
