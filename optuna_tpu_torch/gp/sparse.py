"""Large-n GP engine: SGPR inducing-point posteriors above ``N_EXACT_MAX``
(PyTorch port of ``optuna_tpu/gp/sparse.py``): the fused SGPR program and
the host fit of the non-fused path (:func:`select_inducing_host`,
:func:`fit_gp_sparse`).

With inducing set ``Z`` (m rows), per-row noise precisions
``w_i = count_i / (noise + jitter)`` and cross-covariance ``C = K(Z, X)``:

    A = Kmm + C·diag(w)·Cᵀ,   b = C·diag(w)·y
    μ(x*) = k*ᵀ A⁻¹ b,        var(x*) = k** − k*ᵀ (Kmm⁻¹ − A⁻¹) k*

re-expressed as an exact m-point :class:`~optuna_tpu_torch.gp.gp.GPState`
(``X := Z``, ``alpha := A⁻¹b``, ``L := chol(Kmm + Lmm·G⁻¹·Lmmᵀ)``), so the
LogEI maximizer runs unchanged on it. Hyperparameters are fit by MAP-MLL on
the inducing subset; the projection then conditions on the full history.

``C`` is the one large Gram of the engine and goes through the
hand-written Matérn kernel (:mod:`optuna_tpu_torch.ops.kernels.matern`) on
the card; ``Kmm`` stays plain torch ops, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from optuna_tpu_torch.gp.acqf import LogEIData
from optuna_tpu_torch.gp.fused import _fit_params, _maximize_logei, device_candidates
from optuna_tpu_torch.gp.gp import _JITTER, GPParams, GPState, matern52, posterior
from optuna_tpu_torch.ops.kernels.matern import matern52_gram
from optuna_tpu_torch.samplers._resilience import (
    ladder_cholesky_rank1_raise,
    ladder_cholesky_with_rung,
)

#: History size above which the GP switches from the exact posterior to the
#: SGPR inducing approximation.
N_EXACT_MAX = 1024

#: Inducing-set capacity cap (a fixed-shape (m, d) buffer).
N_INDUCING_MAX = 256

#: Variance swap-in threshold of the scan loop: a new observation whose
#: sparse posterior variance exceeds this fraction of the prior ``scale`` is
#: poorly covered by the inducing set and replaces its most redundant point.
SWAP_VAR_FRAC = 0.25


def _pow2_bucket(n: int) -> int:
    return max(16, 1 << max(0, (n - 1)).bit_length())


def select_inducing_host(X: np.ndarray, m: int) -> np.ndarray:
    """Deterministic farthest-point (k-center) inducing subset on the host,
    for the per-trial refit path, where the whole history is on the host
    anyway. Returns the selected row indices (m,)."""
    n = len(X)
    m = min(m, n)
    chosen = np.empty(m, dtype=np.int64)
    chosen[0] = 0
    d2 = np.sum((X - X[0]) ** 2, axis=1)
    for i in range(1, m):
        chosen[i] = int(np.argmax(d2))
        d2 = np.minimum(d2, np.sum((X - X[chosen[i]]) ** 2, axis=1))
    return chosen


def _decoupled_gram(K: torch.Tensor, valid: torch.Tensor, diag_fill: float) -> torch.Tensor:
    """Zero rows/cols of invalid slots and pin their diagonal, so padded
    inducing slots factor as decoupled identity-like rows."""
    pair = valid[:, None] * valid[None, :]
    K = torch.where(pair > 0, K, torch.zeros_like(K))
    kd = torch.diagonal(K)
    diag = torch.where(valid > 0, kd + _JITTER, torch.full_like(kd, diag_fill))
    return K - torch.diag(kd) + torch.diag(diag)


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(b, L, upper=False)


def sgpr_reduce(
    params: GPParams,
    Z: torch.Tensor,  # (m, d) inducing buffer
    zy: torch.Tensor,  # (m,) inducing targets (standardized), informational
    zmask: torch.Tensor,  # (m,) 1.0 for live inducing slots
    X: torch.Tensor,  # (N, d) full padded history
    y: torch.Tensor,  # (N,) standardized targets
    mask: torch.Tensor,  # (N,) counts; 0 for padding
    cat_mask: torch.Tensor,
):
    """Build the reduced GPState and the tell factors from the full history.

    Returns ``(state, Lmm, L_B, b, rung)``: the whitened Titsias
    factorization ``A = Lmm·B·Lmmᵀ`` with ``B = I + G``,
    ``G = Ah·diag(w)·Ahᵀ``, ``Ah = Lmm⁻¹C``; ``rung`` is the largest
    jitter-ladder rung of the factorizations.
    """
    w = torch.where(mask > 0, mask / (params.noise + _JITTER), torch.zeros_like(mask))
    Kmm = _decoupled_gram(matern52(Z, Z, params, cat_mask), zmask, 1.0)
    C = matern52_gram(Z, X, params.inv_sq_lengthscales, params.scale, cat_mask)
    C = C * zmask[:, None] * (mask > 0).to(C.dtype)[None, :]
    b = (C * w[None, :]) @ y

    Lmm, rung_k = ladder_cholesky_with_rung(Kmm)
    Ah = torch.linalg.solve_triangular(Lmm, C, upper=False)  # (m, N)
    G = (Ah * w[None, :]) @ Ah.T
    G = 0.5 * (G + G.T)
    m = Z.shape[0]
    eye = torch.eye(m, dtype=Z.dtype, device=Z.device)
    L_B, rung_b = ladder_cholesky_with_rung(G + eye)
    alpha = _sparse_alpha(Lmm, L_B, b)

    g_eps = 1e-6 * (1.0 + torch.max(torch.diagonal(G)))
    L_G, _ = ladder_cholesky_with_rung(G + g_eps * eye)
    T = Lmm @ _cho_solve(L_G, Lmm.T)
    M = Kmm + 0.5 * (T + T.T)
    L_var, rung_m = ladder_cholesky_with_rung(M)

    state = GPState(params=params, X=Z, y=zy, mask=zmask, L=L_var, alpha=alpha)
    return state, Lmm, L_B, b, max(rung_k, rung_b, rung_m)


def _sparse_alpha(Lmm, L_B, b):
    """``A⁻¹b`` through the whitened factors: two triangular sandwiches."""
    inner = torch.linalg.solve_triangular(Lmm, b[:, None], upper=False)
    inner = _cho_solve(L_B, inner)
    return torch.linalg.solve_triangular(Lmm.T, inner, upper=True)[:, 0]


def sparse_tell(
    state: GPState,
    Lmm: torch.Tensor,
    L_B: torch.Tensor,
    b: torch.Tensor,
    x_new: torch.Tensor,  # (d,)
    y_new: torch.Tensor,  # () standardized target
    cat_mask: torch.Tensor,
):
    """O(m²) incremental tell: raise ``B`` by ``u·uᵀ`` with
    ``u = √w·Lmm⁻¹v``, ``v = k_m(x_new)``, and refresh ``alpha``. Returns
    ``(state', L_B', b', refactored)``; the variance factor ``state.L`` is
    deliberately left as it is (refreshed by the next :func:`sgpr_reduce`)."""
    params = state.params
    w = 1.0 / (params.noise + _JITTER)
    v = matern52(x_new[None], state.X, params, cat_mask)[0] * state.mask
    u = torch.sqrt(w) * torch.linalg.solve_triangular(Lmm, v[:, None], upper=False)[:, 0]
    L_B2, _rung, refactored = ladder_cholesky_rank1_raise(
        L_B, u, lambda: L_B @ L_B.T + torch.outer(u, u)
    )
    b2 = b + w * y_new * v
    alpha2 = _sparse_alpha(Lmm, L_B2, b2)
    return state._replace(alpha=alpha2), L_B2, b2, refactored


def _select_inducing_device(X: torch.Tensor, mask: torch.Tensor, m_pad: int):
    """Farthest-point selection over the padded history, on the device.

    ``m_pad`` steps of argmax-of-min-distance; masked rows sit at distance
    −inf so they are only chosen once real rows are exhausted (their slots
    stay dead via the returned validity mask). The loop reads nothing back
    to the host: each pick stays a device tensor.
    """
    n = X.shape[0]
    real = mask > 0
    neg_inf = torch.full((n,), -float("inf"), dtype=X.dtype, device=X.device)
    pick = torch.argmax(real.to(torch.int8))  # first real row
    d2 = torch.full((n,), float("inf"), dtype=X.dtype, device=X.device)
    picks = []
    for i in range(m_pad):
        if i > 0:
            pick = torch.argmax(torch.where(real, d2, neg_inf))
        picks.append(pick)
        dist_new = torch.sum((X - X.index_select(0, pick.reshape(1))) ** 2, dim=1)
        d2 = torch.minimum(d2, dist_new)
    idx = torch.stack(picks)
    valid = torch.arange(m_pad, device=X.device) < torch.sum(real)
    return idx, valid


def gp_suggest_sparse_fused(
    starts: torch.Tensor,  # (S, d+2) kernel-param starts
    X: torch.Tensor,  # (N, d) padded observations
    y: torch.Tensor,  # (N,) standardized
    cat_mask: torch.Tensor,  # (d,) bool
    mask: torch.Tensor,  # (N,) counts
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
    q: int = 1,
    m_pad: int = N_INDUCING_MAX,
    n_local_search: int = 10,
    n_cycles: int = 2,
    lbfgs_iters: int = 40,
    fit_iters: int = 60,
    has_sweep: bool = False,
):
    """The sparse twin of ``gp_suggest_fused``: q proposals above the exact
    threshold. Inducing selection → subset MAP fit (O(m³)/iter) → SGPR
    reduction over the full history (O(nm²), the CUDA Gram on the card) →
    q kriging-believer LogEI rounds with O(m²) additive tells. The tell
    after the last round feeds nothing, so it is not run (the reference's
    XLA drops it as dead code). Returns ``(xs, vs, raw, stats)``."""
    idx, zvalid = _select_inducing_device(X, mask, m_pad)
    Z = X[idx]
    zy = y[idx]
    zmask = zvalid.to(X.dtype)

    raw, params, fit_iters_used = _fit_params(
        starts, Z, zy, cat_mask, zmask, minimum_noise, fit_iters
    )
    state, Lmm, L_B, b, rung = sgpr_reduce(params, Z, zy, zmask, X, y, mask, cat_mask)
    noise_c = torch.tensor(stabilizing_noise, dtype=X.dtype, device=X.device)
    best = torch.max(torch.where(mask > 0, y, torch.full_like(y, -float("inf"))))

    xs, vs, nfs = [], [], []
    for i in range(q):
        data = LogEIData(state=state, cat_mask=cat_mask, best=best, stabilizing_noise=noise_c)
        cand = device_candidates(sobol_base, shifts[i], cat_mask, n_choices, steps)
        cand = torch.cat([incumbents, cand], dim=0)
        x_i, v_i, nf_i = _maximize_logei(
            data, cand, gumbels[i], cont_mask, lower, upper,
            dim_onehot, choice_grid, choice_valid,
            n_local_search=n_local_search, n_cycles=n_cycles,
            lbfgs_iters=lbfgs_iters, has_sweep=has_sweep,
        )
        xs.append(x_i)
        vs.append(v_i)
        nfs.append(nf_i)
        if i + 1 < q:
            with torch.no_grad():
                mean_i, _ = posterior(state, x_i[None], cat_mask)
            state, L_B, b, _ = sparse_tell(state, Lmm, L_B, b, x_i, mean_i[0], cat_mask)
            best = torch.maximum(best, mean_i[0])

    xs_t, vs_t = torch.stack(xs), torch.stack(vs)
    n_real = torch.sum(mask > 0)
    m_live = torch.sum(zmask > 0).to(torch.int32)
    stats = {
        "gp.ladder_rung": rung,
        "gp.fit_iterations": fit_iters_used,
        "gp.proposal_fallback_coords": torch.sum(torch.stack(nfs)).to(torch.int32),
        "gp.best_acq": torch.max(vs_t),
        "gp.inducing_count": m_live,
        "gp.sparsity_ratio": m_live.to(torch.float32) / torch.clamp(n_real, min=1).to(torch.float32),
    }
    return xs_t, vs_t, raw, stats


def fit_gp_sparse(
    X: np.ndarray,
    y: np.ndarray,
    is_categorical: np.ndarray,
    warm_start_raw: np.ndarray | None = None,
    minimum_noise: float | None = None,
    n_restarts: int = 4,
    seed: int = 0,
    counts: np.ndarray | None = None,
    n_inducing: int = N_INDUCING_MAX,
    device: "str | torch.device | None" = None,
) -> tuple[GPState, np.ndarray, dict]:
    """Sparse twin of :func:`optuna_tpu_torch.gp.gp.fit_gp` for histories
    above the exact threshold: the same return contract (a reduced m-point
    GPState) plus the inducing stats. The inducing subset is the host
    k-center selection; params fit on the subset, the posterior conditions
    on the whole history through :func:`sgpr_reduce` (K1 once on the card).
    """
    from optuna_tpu_torch._device import resolve_device
    from optuna_tpu_torch.gp.gp import (
        _bucket,
        _fit_kernel_params,
        fit_gp,
        kernel_param_starts,
        padded,
        upload,
    )
    from optuna_tpu_torch.gp.prior import DEFAULT_MINIMUM_NOISE_VAR

    dev = resolve_device(device)
    if minimum_noise is None:
        minimum_noise = DEFAULT_MINIMUM_NOISE_VAR
    n, d = X.shape
    m = min(n_inducing, n)
    if m >= n:  # degenerate call below the regime: exact is strictly better
        return fit_gp(
            X, y, is_categorical, warm_start_raw, minimum_noise,
            n_restarts, seed, counts, n_exact_max=n, device=dev,  # force exact: no re-entry
        )
    sel = select_inducing_host(np.asarray(X, np.float32), m)
    m_pad = _pow2_bucket(m)
    N = _bucket(n)

    Z, zy = upload(padded(X[sel], m_pad), dev), upload(padded(y[sel], m_pad), dev)
    zmask = upload(padded(np.ones(m), m_pad), dev)
    Xp, yp = upload(padded(np.asarray(X), N), dev), upload(padded(np.asarray(y), N), dev)
    mask = upload(padded(np.ones(n) if counts is None else np.asarray(counts), N), dev)
    starts = upload(kernel_param_starts(d, warm_start_raw, n_restarts, seed), dev)
    cat_mask = upload(np.asarray(is_categorical), dev, torch.bool)
    raw = _fit_kernel_params(starts, Z, zy, cat_mask, zmask, float(minimum_noise))
    state, rung = _finalize_sparse(raw, Z, zy, zmask, Xp, yp, mask, cat_mask, float(minimum_noise))
    stats = {"gp.ladder_rung": rung, "gp.inducing_count": m, "gp.sparsity_ratio": m / max(n, 1)}
    return state, raw.detach().cpu().numpy(), stats


def _finalize_sparse(raw, Z, zy, zmask, X, y, mask, cat_mask, minimum_noise: float):
    """The reduced state at ``raw``. The reference's ``has_categorical`` only
    steers its Pallas routing (categorical spaces take its XLA twin); the
    port's K1 carries the Hamming term, so it runs on mixed spaces too."""
    from optuna_tpu_torch.gp.gp import params_from_raw

    with torch.no_grad():
        params = params_from_raw(raw, Z.shape[-1], minimum_noise)
        state, _Lmm, _L_B, _b, rung = sgpr_reduce(params, Z, zy, zmask, X, y, mask, cat_mask)
    return state, rung
