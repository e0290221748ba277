"""The whole exact-GP suggestion as one function (PyTorch port of
``optuna_tpu/gp/fused.py``): ``gp_suggest_fused`` and the q-chain
``gp_suggest_chain_fused`` with their parts.

Pipeline: MAP-fit kernel params (multi-start batched L-BFGS) → Cholesky /
alpha finalize → LogEI over the Sobol candidate pool → Gumbel-top-k start
selection → box-constrained L-BFGS ascent interleaved with dense discrete
sweeps → argmax.

The reference draws its Cranley-Patterson shift and its Gumbel noise from
``jax.random`` inside the program. PyTorch cannot reproduce those streams,
so here they are explicit tensor arguments (``shift``, ``gumbel``; one row
of each a round for the chain, the reference's ``fold_in(key, i)``): the
sampler draws them from a ``torch.Generator``, and the tests hand in the
reference's own draws to compare the two programs end to end.

``jax.vmap(jax.value_and_grad(loss))`` over the fit's starts (and over the
acquisition's local-search points) becomes one batched loss whose sum is
differentiated: the batch rows are independent, so the gradient of the sum
holds each row's own gradient.
"""

from __future__ import annotations

import torch

from optuna_tpu_torch.gp.acqf import LogEIData, logei_value
from optuna_tpu_torch.gp.gp import (
    GPParams,
    GPState,
    _kernel_with_noise,
    _loss,
    params_from_raw,
    posterior,
)
from optuna_tpu_torch.ops.lbfgsb import lbfgsb
from optuna_tpu_torch.samplers._resilience import ladder_cholesky_with_rung


def _finite_or_zero(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _fit_params(starts, X, y, cat_mask, mask, minimum_noise, fit_iters, max_ls: int = 12):
    """Multi-start MAP fit of raw log kernel params; returns the winning raw
    vector, the decoded GPParams, and the L-BFGS iteration count."""

    def value_and_grad(batch_raw):
        with torch.enable_grad():
            r = batch_raw.detach().requires_grad_(True)
            vals = _loss(r, X, y, cat_mask, mask, minimum_noise)
            (grads,) = torch.autograd.grad(vals.sum(), r)
        return vals.detach(), _finite_or_zero(grads)

    def value_only(batch_raw):
        with torch.no_grad():
            return _loss(batch_raw, X, y, cat_mask, mask, minimum_noise)

    D = starts.shape[1]
    lower = torch.full((D,), -15.0, dtype=starts.dtype, device=starts.device)
    upper = torch.full((D,), 15.0, dtype=starts.dtype, device=starts.device)
    xs, fs, n_iter = lbfgsb(
        value_and_grad, starts, lower, upper, max_iters=fit_iters, max_ls=max_ls,
        value_fn=value_only, return_n_iter=True,
    )
    raw = xs[torch.argmin(fs)]
    return raw, params_from_raw(raw, X.shape[-1], minimum_noise), n_iter


def _state_for(params, X, y, cat_mask, mask):
    K = _kernel_with_noise(X, params, cat_mask, mask)
    # Jitter-ladder factorization: duplicate design rows make K
    # rank-deficient; the rung rides out with the state.
    L, rung = ladder_cholesky_with_rung(K)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return GPState(params=params, X=X, y=y, mask=mask, L=L, alpha=alpha), rung


def device_candidates(sobol_base, shift, cat_mask, n_choices, steps):
    """Decode a shifted Sobol pool into the normalized mixed space.

    ``sobol_base`` (C, d) stays on the device across trials; ``shift`` (d,)
    in [0, 1) is the per-call Cranley-Patterson rotation. Categorical dims
    decode to a choice index, stepped dims snap to grid centers, continuous
    dims pass through.
    """
    u = torch.remainder(sobol_base + shift[None, :], 1.0)
    nc = torch.clamp(n_choices, min=1.0)
    cat_vals = torch.clamp(torch.floor(u * nc[None, :]), torch.zeros_like(nc), nc - 1.0)
    safe_step = torch.where(steps > 0, steps, torch.ones_like(steps))
    stepped = torch.clamp(safe_step[None, :] * (torch.floor(u / safe_step[None, :]) + 0.5), 0.0, 1.0)
    return torch.where(cat_mask[None, :], cat_vals, torch.where(steps[None, :] > 0, stepped, u))


def gumbel_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """(n,) standard Gumbel draws, ``-log(-log(U))`` with U in [tiny, 1) as
    ``jax.random.gumbel`` forms them."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(n, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=tiny)
    return -torch.log(-torch.log(u))


def _maximize_logei(
    data,
    candidates,
    gumbel,
    cont_mask,
    lower,
    upper,
    dim_onehot,
    choice_grid,
    choice_valid,
    *,
    n_local_search,
    n_cycles,
    lbfgs_iters,
    has_sweep,
):
    """Preliminary sweep → Gumbel-top-k starts → cyclic L-BFGS + discrete
    sweeps → (x*, value*, fallback coordinate count).

    ``gumbel`` (C,) is the start-selection noise, one draw per candidate.
    ``torch.topk`` may order exact ties differently from ``lax.top_k``."""
    with torch.no_grad():
        vals = logei_value(data, candidates)
    vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, -float("inf")))
    # Start selection: argmax + Gumbel-top-k == softmax sampling without
    # replacement (the reference's roulette).
    _, noisy_idx = torch.topk(vals + gumbel, n_local_search)
    idx = torch.cat([torch.argmax(vals)[None], noisy_idx[1:]])
    x = candidates[idx]
    cur = vals[idx]

    def neg_batch(xb):
        with torch.enable_grad():
            xr = xb.detach().requires_grad_(True)
            v = -logei_value(data, xr)
            (g,) = torch.autograd.grad(v.sum(), xr)
        g = torch.where(cont_mask[None, :] > 0, g, torch.zeros_like(g))
        return v.detach(), _finite_or_zero(g)

    def neg_values(xb):
        with torch.no_grad():
            return -logei_value(data, xb)

    def sweep(x, cur):
        B, d = x.shape
        Dd, Cmax = choice_grid.shape
        base = x[:, None, None, :] * (1.0 - dim_onehot[None, :, None, :])
        repl = choice_grid[None, :, :, None] * dim_onehot[None, :, None, :]
        cand = base + repl
        with torch.no_grad():
            v = logei_value(data, cand.reshape(-1, d)).reshape(B, Dd, Cmax)
        v = torch.where(choice_valid[None], v, torch.full_like(v, -float("inf")))
        flat = v.reshape(B, Dd * Cmax)
        bi = torch.argmax(flat, dim=1)
        bv = torch.gather(flat, 1, bi[:, None])[:, 0]
        bc = cand.reshape(B, Dd * Cmax, d)[torch.arange(B, device=x.device), bi]
        improve = bv > cur
        return torch.where(improve[:, None], bc, x), torch.maximum(bv, cur)

    for _ in range(n_cycles):
        x_new, neg_new = lbfgsb(
            neg_batch, x, lower, upper, max_iters=lbfgs_iters, max_ls=10,
            value_fn=neg_values,
        )
        v_new = -neg_new
        better = v_new > cur
        x = torch.where(better[:, None], x_new, x)
        cur = torch.maximum(v_new, cur)
        if has_sweep:
            x, cur = sweep(x, cur)

    winner = torch.argmax(cur)
    x_win = x[winner]
    # Per-coordinate fallback to the best preliminary candidate should the
    # ascent ever walk a coordinate to NaN/Inf.
    finite = torch.isfinite(x_win)
    n_fallback = torch.sum(~finite).to(torch.int32)
    prelim_best = candidates[torch.argmax(vals)]
    x_win = torch.where(finite, x_win, prelim_best)
    return x_win, cur[winner], n_fallback


def gp_suggest_fused(
    starts: torch.Tensor,  # (S, d+2) kernel-param starts
    X: torch.Tensor,  # (N, d) padded observations
    y: torch.Tensor,  # (N,)
    cat_mask: torch.Tensor,  # (d,) bool
    mask: torch.Tensor,  # (N,)
    sobol_base: torch.Tensor,  # (C, d) device-resident Sobol pool
    incumbents: torch.Tensor,  # (I, d) recent observed points joining the pool
    shift: torch.Tensor,  # (d,) Cranley-Patterson shift in [0, 1)
    gumbel: torch.Tensor,  # (I + C,) start-selection noise
    minimum_noise: float,
    cont_mask: torch.Tensor,  # (d,)
    lower: torch.Tensor,  # (d,)
    upper: torch.Tensor,  # (d,)
    n_choices: torch.Tensor,  # (d,) float; 0 for non-categorical
    steps: torch.Tensor,  # (d,) normalized step; 0 => continuous
    dim_onehot: torch.Tensor,  # (Dd, d) sweep tables (dummy (1,d) when unused)
    choice_grid: torch.Tensor,  # (Dd, Cmax)
    choice_valid: torch.Tensor,  # (Dd, Cmax)
    stabilizing_noise: float = 1e-10,
    n_local_search: int = 10,
    n_cycles: int = 2,
    lbfgs_iters: int = 40,
    fit_iters: int = 60,
    has_sweep: bool = False,
):
    """One exact-GP suggestion; returns ``(x_best, v_best, raw, stats)``."""
    raw, params, fit_iters_used = _fit_params(
        starts, X, y, cat_mask, mask, minimum_noise, fit_iters
    )
    state, rung = _state_for(params, X, y, cat_mask, mask)
    best = torch.max(torch.where(mask > 0, y, torch.full_like(y, -float("inf"))))
    data = LogEIData(
        state=state,
        cat_mask=cat_mask,
        best=best,
        stabilizing_noise=torch.tensor(stabilizing_noise, dtype=X.dtype, device=X.device),
    )
    cand = device_candidates(sobol_base, shift, cat_mask, n_choices, steps)
    cand = torch.cat([incumbents, cand], dim=0)
    x_best, v_best, n_fallback = _maximize_logei(
        data, cand, gumbel, cont_mask, lower, upper,
        dim_onehot, choice_grid, choice_valid,
        n_local_search=n_local_search, n_cycles=n_cycles,
        lbfgs_iters=lbfgs_iters, has_sweep=has_sweep,
    )
    stats = {
        "gp.ladder_rung": rung,
        "gp.fit_iterations": fit_iters_used,
        "gp.proposal_fallback_coords": n_fallback,
        "gp.best_acq": v_best,
    }
    return x_best, v_best, raw, stats


def gp_suggest_chain_fused(
    starts: torch.Tensor,  # (S, d+2)
    X: torch.Tensor,  # (N, d) padded, with >= q free (masked-off) slots
    y: torch.Tensor,  # (N,)
    cat_mask: torch.Tensor,  # (d,) bool
    mask: torch.Tensor,  # (N,)
    n_real: int,  # index of the first free slot
    sobol_base: torch.Tensor,  # (C, d)
    incumbents: torch.Tensor,  # (I, d)
    shifts: torch.Tensor,  # (q, d) per-round Cranley-Patterson shifts
    gumbels: torch.Tensor,  # (q, I + C) per-round start-selection noise
    minimum_noise: float,
    cont_mask: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    n_choices: torch.Tensor,
    steps: torch.Tensor,
    dim_onehot: torch.Tensor,
    choice_grid: torch.Tensor,
    choice_valid: torch.Tensor,
    stabilizing_noise: float = 1e-10,
    q: int = 8,
    n_local_search: int = 6,
    n_cycles: int = 1,
    lbfgs_iters: int = 20,
    fit_iters: int = 30,
    has_sweep: bool = False,
):
    """q joint proposals from one call via kriging-believer fantasies.

    The kernel-param fit runs once for the whole chain; each round refactors
    the (masked) extended history, maximizes LogEI, then writes the
    posterior mean at the winner into slot ``n_real + i``. The reference
    writes the slots with ``.at[slot].set`` inside ``lax.scan``; here they
    are written into clones of the inputs, and ``n_real`` is a Python int, so no device
    scalar is read to index. Returns ``(xs, vs, raw, stats)``."""
    raw, params, fit_iters_used = _fit_params(
        starts, X, y, cat_mask, mask, minimum_noise, fit_iters
    )
    noise_c = torch.tensor(stabilizing_noise, dtype=X.dtype, device=X.device)
    Xc, yc, mc = X.clone(), y.clone(), mask.clone()
    xs, vs, rungs, nfs = [], [], [], []
    for i in range(q):
        with torch.no_grad():
            state, rung_i = _state_for(params, Xc, yc, cat_mask, mc)
        best = torch.max(torch.where(mc > 0, yc, torch.full_like(yc, -float("inf"))))
        data = LogEIData(state=state, cat_mask=cat_mask, best=best, stabilizing_noise=noise_c)
        cand = device_candidates(sobol_base, shifts[i], cat_mask, n_choices, steps)
        cand = torch.cat([incumbents, cand], dim=0)
        x_i, v_i, nf_i = _maximize_logei(
            data, cand, gumbels[i], cont_mask, lower, upper,
            dim_onehot, choice_grid, choice_valid,
            n_local_search=n_local_search, n_cycles=n_cycles,
            lbfgs_iters=lbfgs_iters, has_sweep=has_sweep,
        )
        with torch.no_grad():
            mean_i, _ = posterior(state, x_i[None], cat_mask)
        slot = n_real + i  # round i's state is done with: write in place
        Xc[slot] = x_i
        yc[slot] = mean_i[0]
        mc[slot] = 1.0
        xs.append(x_i)
        vs.append(v_i)
        rungs.append(rung_i)
        nfs.append(nf_i)
    xs_t, vs_t = torch.stack(xs), torch.stack(vs)
    stats = {
        "gp.ladder_rung": max(rungs),
        "gp.fit_iterations": fit_iters_used,
        "gp.proposal_fallback_coords": torch.sum(torch.stack(nfs)).to(torch.int32),
        "gp.best_acq": torch.max(vs_t),
    }
    return xs_t, vs_t, raw, stats


# Compile/retrace gauges (optuna_tpu_torch.flight): a new history bucket or
# start count is a new call signature of the fused programs, the place the
# GP path pays again for a new shape. One check per call while recording is
# off.
from optuna_tpu_torch import flight as _flight  # noqa: E402 (gauge wiring below the programs)

gp_suggest_fused = _flight.instrument_jit(gp_suggest_fused, "gp.suggest_fused")
gp_suggest_chain_fused = _flight.instrument_jit(gp_suggest_chain_fused, "gp.suggest_chain_fused")
