"""Mixed continuous/discrete/categorical acquisition maximizer (port of
``optuna_tpu/gp/optim_mixed.py``), the non-fused path: QMC preliminary
candidates → roulette-picked starts → cyclic local search alternating
batched L-BFGS over the continuous dims with a dense sweep of every
single-coordinate move over the discrete and categorical dims.

The candidate pool (``space.sample_normalized`` with a seed drawn from the
caller's ``RandomState``) and the roulette (the same ``RandomState``) are
host draws, so they are the reference's bit for bit; the acquisition runs
on the data's device. The ascent reads the host once an L-BFGS iteration
and once a cycle, as the reference's host loop does.
"""

from __future__ import annotations

import numpy as np
import torch

from optuna_tpu_torch.gp.acqf import ACQF_VALUE_FNS, data_device
from optuna_tpu_torch.gp.search_space import ScaleType, SearchSpace, _round_to_step_grid

_MAX_ENUM_CHOICES = 32
# High-cardinality discrete dims (> _MAX_ENUM_CHOICES grid points) are swept
# over a subsampled grid of this many points, snapped onto true grid
# centers so every proposal stays feasible.
_LINE_SEARCH_POINTS = 64
# EHVI materializes (S_qmc, K_boxes, M_obj, chunk) tensors; bounding the
# candidate chunk bounds the preliminary sweep's memory.
_EVAL_CHUNK = 256


def eval_acqf(acqf_name: str, data, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return ACQF_VALUE_FNS[acqf_name](data, x)


def eval_acqf_chunked(acqf_name: str, data, x: torch.Tensor) -> np.ndarray:
    """:func:`eval_acqf` over chunks of ``_EVAL_CHUNK`` candidates, read to
    the host once. Rows are independent, so the reference's padding of the
    tail chunk (for XLA's shapes) changes no value and is left out."""
    parts = [eval_acqf(acqf_name, data, x[s : s + _EVAL_CHUNK]) for s in range(0, x.shape[0], _EVAL_CHUNK)]
    return torch.cat(parts).double().cpu().numpy()


def _finite_or_zero(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _local_search_continuous(
    acqf_name: str,
    data,
    x0: torch.Tensor,  # (B, d)
    cont_mask: torch.Tensor,  # (d,) 1.0 for continuous dims
    lower: torch.Tensor,
    upper: torch.Tensor,
    max_iters: int = 50,
):
    """Batched L-BFGS ascent of the acquisition from ``x0``; the gradient
    of the discrete dims is zeroed. Returns (x_opt, value_opt)."""
    from optuna_tpu_torch.ops.lbfgsb import lbfgsb

    value_fn = ACQF_VALUE_FNS[acqf_name]

    def vag(xb):
        with torch.enable_grad():
            xr = xb.detach().requires_grad_(True)
            vals = -value_fn(data, xr)
            (grads,) = torch.autograd.grad(vals.sum(), xr)
        grads = torch.where(cont_mask[None, :] > 0, grads, torch.zeros_like(grads))
        return vals.detach(), _finite_or_zero(grads)

    def values(xb):
        with torch.no_grad():
            return -value_fn(data, xb)

    x_opt, f_opt = lbfgsb(vag, x0, lower, upper, max_iters=max_iters, value_fn=values)
    return x_opt, -f_opt


def _discrete_sweep(
    acqf_name: str,
    data,
    x: torch.Tensor,  # (B, d)
    cur_val: torch.Tensor,  # (B,)
    dim_onehot: torch.Tensor,  # (Dd, d) one-hot row per swept dim
    choice_grid: torch.Tensor,  # (Dd, Cmax) candidate values per swept dim
    choice_valid: torch.Tensor,  # (Dd, Cmax) bool
):
    """Evaluate every single-coordinate move; apply the best improving one.
    Returns (x, values, any improved) with the last a device bool."""
    B, d = x.shape
    Dd, Cmax = choice_grid.shape
    # cand[b, i, c] = x[b] with dim i's coordinate replaced by grid[i, c]
    base = x[:, None, None, :] * (1.0 - dim_onehot[None, :, None, :])
    repl = choice_grid[None, :, :, None] * dim_onehot[None, :, None, :]
    cand = base + repl  # (B, Dd, Cmax, d)
    vals = eval_acqf(acqf_name, data, cand.reshape(-1, d)).reshape(B, Dd, Cmax)
    vals = torch.where(choice_valid[None], vals, torch.full_like(vals, -float("inf")))
    flat = vals.reshape(B, Dd * Cmax)
    best_idx = torch.argmax(flat, dim=1)
    best_val = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    best_cand = cand.reshape(B, Dd * Cmax, d)[torch.arange(B, device=x.device), best_idx]
    improve = best_val > cur_val
    new_x = torch.where(improve[:, None], best_cand, x)
    new_val = torch.where(improve, best_val, cur_val)
    return new_x, new_val, torch.any(improve)


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


def optimize_acqf_mixed(
    acqf_name: str,
    data,
    space: SearchSpace,
    rng: np.random.RandomState,
    extra_candidates: np.ndarray | None = None,
    n_preliminary: int = 2048,
    n_local_search: int = 10,
    n_cycles: int = 3,
    lbfgs_iters: int = 50,
) -> tuple[np.ndarray, float]:
    """Maximize the acquisition over the normalized mixed space; returns the
    snapped winner (float64, host) and its value.

    ``extra_candidates`` (e.g. the recent observations) join the QMC pool so
    local search can warm-start from incumbents."""
    from optuna_tpu_torch.gp.gp import upload

    device = data_device(data)

    def up(a, dtype=torch.float32):
        return upload(a, device, dtype)

    cand = space.sample_normalized(n_preliminary, seed=int(rng.randint(0, 2**31 - 1)))
    if extra_candidates is not None and len(extra_candidates):
        cand = np.concatenate([extra_candidates, cand], axis=0)
    vals = eval_acqf_chunked(acqf_name, data, up(cand))
    vals = np.where(np.isfinite(vals), vals, -np.inf)

    # Roulette selection of local-search starts: always the argmax, the rest
    # by softmax-probability sampling without replacement.
    n_starts = min(n_local_search, len(cand))
    order = np.argsort(vals)[::-1]
    chosen = [order[0]]
    rest = order[1:]
    if len(rest) and n_starts > 1:
        logits = vals[rest] - np.max(vals[rest][np.isfinite(vals[rest])], initial=0.0)
        probs = np.exp(np.clip(logits, -700, 0))
        if probs.sum() <= 0 or not np.isfinite(probs.sum()):
            probs = np.ones(len(rest))
        probs /= probs.sum()
        picked = rng.choice(len(rest), size=min(n_starts - 1, len(rest)), replace=False, p=probs)
        chosen.extend(rest[picked].tolist())
    x = up(cand[np.asarray(chosen)])
    cur = eval_acqf(acqf_name, data, x)

    cont_mask_np, lower_np, upper_np = continuous_bounds(space)
    has_continuous = bool(cont_mask_np.sum() > 0)
    cont_mask, lower, upper = up(cont_mask_np), up(lower_np), up(upper_np)
    tables = _sweep_tables(space)
    if tables is not None:
        onehot, grid, valid = up(tables[0]), up(tables[1]), up(tables[2], torch.bool)

    for _ in range(n_cycles):
        improved = False
        if has_continuous:
            x_new, vals_new = _local_search_continuous(
                acqf_name, data, x, cont_mask, lower, upper, max_iters=lbfgs_iters
            )
            better = vals_new > cur
            x = torch.where(better[:, None], x_new, x)
            cur = torch.maximum(vals_new, cur)
            improved = bool(torch.any(better))
        if tables is not None:
            x, cur, any_improve = _discrete_sweep(acqf_name, data, x, cur, onehot, grid, valid)
            improved = improved or bool(any_improve)
        if not improved:
            break

    cur_np = cur.double().cpu().numpy()
    best = int(np.argmax(cur_np))
    x_best = snap_steps(space, x[best].double().cpu().numpy())
    return x_best, float(cur_np[best])


def optimize_acqf_sample(
    acqf_name: str,
    data,
    space: SearchSpace,
    rng: np.random.RandomState,
    n_samples: int = 2048,
) -> tuple[np.ndarray, float]:
    """Pure QMC argmax fallback."""
    from optuna_tpu_torch.gp.gp import upload

    cand = space.sample_normalized(n_samples, seed=int(rng.randint(0, 2**31 - 1)))
    vals = eval_acqf(acqf_name, data, upload(cand, data_device(data))).double().cpu().numpy()
    best = int(np.argmax(np.where(np.isfinite(vals), vals, -np.inf)))
    return cand[best].astype(np.float64), float(vals[best])
