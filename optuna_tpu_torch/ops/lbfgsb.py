"""Batched box-constrained L-BFGS (PyTorch port of ``optuna_tpu/ops/lbfgsb.py``).

Projected-gradient L-BFGS with Armijo backtracking onto the box, with
per-instance convergence freezing so finished instances idle in place. Every
iterate carries a leading batch axis; the two-loop recursion runs on stacked
(s, y) histories.

The reference's ``lax.while_loop`` is a Python loop here. Its exit test
reads one boolean from the device per iteration: that is this module's one
host sync, and the first place a trace of the GP ask should look.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

ValueAndGrad = Callable[[torch.Tensor], "tuple[torch.Tensor, torch.Tensor]"]


def _two_loop(
    g: torch.Tensor,  # (B, D)
    s_hist: torch.Tensor,  # (M, B, D)
    y_hist: torch.Tensor,  # (M, B, D)
    rho: torch.Tensor,  # (M, B), 0 for empty/invalid slots
    gamma: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Two-loop recursion over the (masked) history; returns the descent direction."""
    M = s_hist.shape[0]
    valid = rho != 0.0  # (M, B)
    vf = valid.to(g.dtype)
    alphas = [torch.zeros_like(gamma)] * M
    q = g
    for i in reversed(range(M)):  # newest to oldest
        alphas[i] = torch.where(valid[i], rho[i] * torch.sum(s_hist[i] * q, dim=-1), 0.0)
        q = q - alphas[i][:, None] * y_hist[i] * vf[i][:, None]
    r = gamma[:, None] * q
    for i in range(M):
        beta = torch.where(valid[i], rho[i] * torch.sum(y_hist[i] * r, dim=-1), 0.0)
        r = r + (alphas[i] - beta)[:, None] * s_hist[i] * vf[i][:, None]
    return -r


def lbfgsb(
    value_and_grad_fn: ValueAndGrad,
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    max_iters: int = 200,
    history: int = 10,
    tol: float = 1e-8,
    max_ls: int = 16,
    value_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    return_n_iter: bool = False,
) -> tuple:
    """Minimize ``B`` independent instances of a box-constrained problem.

    ``value_and_grad_fn`` maps (B, D) -> ((B,), (B, D)); returns
    (x_opt (B, D), f_opt (B,)) and, with ``return_n_iter``, the iteration
    count. The Armijo backtracking evaluates all ``max_ls`` step sizes in ONE
    batched call of ``value_fn`` (else the value part of
    ``value_and_grad_fn``) on the (max_ls·B, D) stack of trial points, so
    the sequential depth per iteration is two evaluations. The batch rows
    must be independent problems, as in the reference's ``vmap``.
    """
    B, D = x0.shape
    x = torch.clamp(x0, lower, upper)
    f, g = value_and_grad_fn(x)
    dtype, device = x.dtype, x.device

    s_hist = torch.zeros((history, B, D), dtype=dtype, device=device)
    y_hist = torch.zeros((history, B, D), dtype=dtype, device=device)
    rho = torch.zeros((history, B), dtype=dtype, device=device)
    gamma = torch.ones(B, dtype=dtype, device=device)
    converged = torch.zeros(B, dtype=torch.bool, device=device)

    ls_alphas = torch.as_tensor(0.5 ** np.arange(max_ls), dtype=dtype, device=device)
    eval_values = value_fn if value_fn is not None else (lambda xb: value_and_grad_fn(xb)[0])
    rows = torch.arange(B, device=device)

    n_iter = 0
    while n_iter < max_iters and not bool(torch.all(converged)):  # graphlint: ignore[TPU001] -- one host read an iteration ends the loop once every row has converged; converged rows are frozen, so the read only saves work (dropping it is ROADMAP H4)
        d = _two_loop(g, s_hist, y_hist, rho, gamma)
        # Safeguard: fall back to steepest descent if not a descent direction.
        descent = torch.sum(d * g, dim=-1) < 0
        d = torch.where(descent[:, None], d, -g)

        # Batched Armijo: every candidate step in one call, written out as
        # the (L, B, D) -> (L·B, D) reshape of the reference's vmap.
        x_trys = torch.clamp(x[None] + ls_alphas[:, None, None] * d[None], lower, upper)
        f_trys = eval_values(x_trys.reshape(max_ls * B, D)).reshape(max_ls, B)
        armijo_rhs = f[None, :] + 1e-4 * torch.sum(g[None] * (x_trys - x[None]), dim=-1)
        ok = (f_trys <= armijo_rhs) & torch.isfinite(f_trys)
        # First (largest-step) accepted alpha per instance.
        first = torch.argmax(ok.to(torch.int8), dim=0)  # (B,)
        ls_ok = torch.any(ok, dim=0) & ~converged
        x_new = torch.where(ls_ok[:, None], x_trys[first, rows], x)
        f_new = torch.where(ls_ok, f_trys[first, rows], f)

        _, g_new = value_and_grad_fn(x_new)
        s = x_new - x
        y = g_new - g
        sy = torch.sum(s * y, dim=-1)
        curv_ok = (sy > 1e-10) & ls_ok

        # Push into the circular history (roll + write newest at the end).
        slot_rho = torch.where(curv_ok, 1.0 / torch.where(curv_ok, sy, torch.ones_like(sy)), 0.0)
        s_roll = torch.cat([s_hist[1:], s[None]], dim=0)
        y_roll = torch.cat([y_hist[1:], y[None]], dim=0)
        rho_roll = torch.cat([rho[1:], slot_rho[None]], dim=0)
        yy = torch.sum(y * y, dim=-1)
        gamma_new = torch.where(
            curv_ok & (yy > 0), sy / torch.where(yy > 0, yy, torch.ones_like(yy)), gamma
        )

        pg = x_new - torch.clamp(x_new - g_new, lower, upper)
        now_converged = converged | (torch.amax(torch.abs(pg), dim=-1) < tol) | ~ls_ok
        keep = converged
        x = torch.where(keep[:, None], x, x_new)
        f = torch.where(keep, f, f_new)
        g = torch.where(keep[:, None], g, g_new)
        s_hist = torch.where(keep[None, :, None], s_hist, s_roll)
        y_hist = torch.where(keep[None, :, None], y_hist, y_roll)
        rho = torch.where(keep[None, :], rho, rho_roll)
        gamma = torch.where(keep, gamma, gamma_new)
        converged = now_converged
        n_iter += 1

    if return_n_iter:
        return x, f, n_iter
    return x, f


def minimize_scalar_log_params(
    value_and_grad_fn: ValueAndGrad,
    x0: torch.Tensor,
    bounds: tuple[float, float] = (-20.0, 20.0),
    max_iters: int = 200,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Convenience wrapper for unconstrained-ish log-parameter fitting (GP MLL):
    wide box bounds keep exp() finite without constraining the optimum."""
    B, D = x0.shape
    lower = torch.full((D,), bounds[0], dtype=x0.dtype, device=x0.device)
    upper = torch.full((D,), bounds[1], dtype=x0.dtype, device=x0.device)
    return lbfgsb(value_and_grad_fn, x0, lower, upper, max_iters=max_iters)
