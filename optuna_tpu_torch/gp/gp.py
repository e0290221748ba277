"""Matern-5/2 ARD Gaussian process: kernel, MLL, posterior (PyTorch port of
``optuna_tpu/gp/gp.py``).

Same f32 numerical contract as the reference: standardized targets, a noise
floor plus 1e-6 additive jitter, log-parameters clamped to [-15, 15] during
the fit, and non-finite loss/gradient guards so a failed Cholesky never
poisons the multi-start L-BFGS. Trial counts are padded to power-of-two
buckets; padded rows carry an enormous noise so they affect neither the MLL
gradient nor the posterior.

The functions here take kernel parameters with optional leading batch
dimensions: the reference ``vmap``s one loss over the fit's starts, the port
writes that batch axis out (``raw`` of shape (S, d+2) gives S losses).
Stacked states (one GP per objective or constraint, every tensor with a
leading axis) are queried by :func:`posterior_stacked`, where the reference
``vmap``s :func:`posterior`.

:func:`fit_gp` is the host fit of the non-fused path: batched multi-start
L-BFGS on the device, the padding and the starts on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from optuna_tpu_torch.gp.prior import DEFAULT_MINIMUM_NOISE_VAR, log_prior

_JITTER = 1e-6
_PAD_NOISE = 1e8
_SQRT5 = math.sqrt(5.0)


class GPParams(NamedTuple):
    inv_sq_lengthscales: torch.Tensor  # (..., d)
    scale: torch.Tensor  # (...)
    noise: torch.Tensor  # (...)


class GPState(NamedTuple):
    """Fitted GP ready for posterior queries (all padded to bucket size)."""

    params: GPParams
    X: torch.Tensor  # (N, d) padded
    y: torch.Tensor  # (N,) padded with 0
    mask: torch.Tensor  # (N,) counts for real rows, 0 for padding
    L: torch.Tensor  # (N, N) cholesky of K + noise
    alpha: torch.Tensor  # (N,) K^{-1} y


def cholesky_or_nan(K: torch.Tensor) -> torch.Tensor:
    """Cholesky that fails the way the reference's does: JAX returns a NaN
    factor for a matrix that is not positive definite, while
    ``torch.linalg.cholesky_ex`` returns a partial factor that may be finite
    and wrong, with ``info > 0``. Mapping ``info > 0`` to NaN keeps every
    downstream guard (``isfinite`` on the loss, the jitter ladder) meaning
    what it means in the reference. No host sync."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _sq_dist_terms(x1: torch.Tensor, x2: torch.Tensor, cat_mask: torch.Tensor) -> torch.Tensor:
    """(n1, n2, d) per-dimension squared distances; Hamming on categorical dims."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return torch.where(cat_mask, (diff != 0.0).to(x1.dtype), diff * diff)


def _scaled_d2(
    x1: torch.Tensor, x2: torch.Tensor, inv_sq_ls: torch.Tensor, cat_mask: torch.Tensor
) -> torch.Tensor:
    """Pairwise ARD-scaled squared distance.

    Unbatched weights (d,) give (n1, n2). Batched weights (S, d) share the
    per-dimension terms and contract them once, giving (S, n1, n2) without
    an (S, n1, n2, d) intermediate."""
    sq = _sq_dist_terms(x1, x2, cat_mask)
    if inv_sq_ls.dim() == 1:
        return torch.sum(sq * inv_sq_ls, dim=-1)
    return torch.matmul(sq, inv_sq_ls.T).permute(2, 0, 1)


def matern52(
    x1: torch.Tensor,
    x2: torch.Tensor,
    params: GPParams,
    cat_mask: torch.Tensor,
) -> torch.Tensor:
    """Matern-5/2 kernel matrix. ``sqrt`` at d2=0 is made autograd-safe with
    the double ``where`` (the sqrt only ever sees positive inputs, so the
    Gram diagonal gives finite gradients)."""
    d2 = _scaled_d2(x1, x2, params.inv_sq_lengthscales, cat_mask)
    return _matern_of_d2(d2, params.scale[..., None, None])


def _matern_of_d2(d2: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    pos = d2 > 0
    safe = torch.where(pos, d2, torch.ones_like(d2))
    d = torch.where(pos, torch.sqrt(safe), torch.zeros_like(d2))
    sqrt5d = _SQRT5 * d
    return scale * (1.0 + sqrt5d + (5.0 / 3.0) * d2) * torch.exp(-sqrt5d)


def _kernel_with_noise(
    X: torch.Tensor, params: GPParams, cat_mask: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    K = matern52(X, X, params, cat_mask)
    n = X.shape[-2]
    # Real rows get (noise + jitter) / count; padded rows get huge noise,
    # which makes their alpha ~ 0 and their MLL contribution
    # parameter-independent (reference gp.py:89-107).
    noise = params.noise[..., None]
    diag = torch.where(
        mask > 0,
        (noise + _JITTER) / torch.clamp(mask, min=1.0),
        torch.full_like(mask, _PAD_NOISE),
    )
    return K + torch.eye(n, dtype=X.dtype, device=X.device) * diag[..., None, :]


def marginal_log_likelihood(
    params: GPParams,
    X: torch.Tensor,
    y: torch.Tensor,
    cat_mask: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Exact MLL via Cholesky, padding-aware; batched over the params' leading dims."""
    K = _kernel_with_noise(X, params, cat_mask, mask)
    L = cholesky_or_nan(K)
    yb = y.expand(K.shape[:-1])[..., None]
    alpha = torch.cholesky_solve(yb, L)[..., 0]
    n_real = torch.sum(mask)
    quad = torch.sum(y * alpha, dim=-1)
    # Padded rows contribute log(sqrt(PAD_NOISE)) ~ constant; leave them out
    # so the MLL magnitude stays comparable across bucket sizes.
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.where(mask > 0, torch.log(diag), torch.zeros_like(diag)), dim=-1)
    return -0.5 * (quad + logdet + n_real * math.log(2.0 * math.pi))


def params_from_raw(raw: torch.Tensor, d: int, minimum_noise: float) -> GPParams:
    """Decode raw log-parameters (..., d+2) into GPParams."""
    return GPParams(
        inv_sq_lengthscales=torch.exp(raw[..., :d]),
        scale=torch.exp(raw[..., d]),
        noise=torch.exp(raw[..., d + 1]) + minimum_noise,
    )


def _loss(
    raw: torch.Tensor,  # (..., d+2) log-params
    X: torch.Tensor,
    y: torch.Tensor,
    cat_mask: torch.Tensor,
    mask: torch.Tensor,
    minimum_noise: float,
) -> torch.Tensor:
    """Negative log posterior of the kernel params; 1e10 where the Cholesky
    failed, so a failed start never poisons the optimizer."""
    params = params_from_raw(raw, X.shape[-1], minimum_noise)
    mll = marginal_log_likelihood(params, X, y, cat_mask, mask)
    lp = log_prior(params.inv_sq_lengthscales, params.scale, params.noise)
    nll = -(mll + lp)
    return torch.where(torch.isfinite(nll), nll, torch.full_like(nll, 1e10))


def _bucket(n: int) -> int:
    return max(16, 1 << (n - 1).bit_length())


def posterior(
    state: GPState, x: torch.Tensor, cat_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/variance at query points x (m, d)."""
    k_star = matern52(x, state.X, state.params, cat_mask)  # (m, N)
    mean = k_star @ state.alpha
    v = torch.linalg.solve_triangular(state.L, k_star.T, upper=False)  # (N, m)
    var = state.params.scale - torch.sum(v * v, dim=0)
    var = torch.clamp(var, min=1e-10)
    return mean, var


def posterior_stacked(
    states: GPState, x: torch.Tensor, cat_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`posterior` of M stacked states (every field with a leading
    axis M) at the same query points x (m, d): means and variances (M, m).
    The reference ``vmap``s :func:`posterior`; the arithmetic is the same."""
    params = states.params
    sq = _sq_dist_terms(x, states.X, cat_mask)  # (M, m, N, d)
    d2 = torch.sum(sq * params.inv_sq_lengthscales[:, None, None, :], dim=-1)
    k_star = _matern_of_d2(d2, params.scale[:, None, None])  # (M, m, N)
    mean = (k_star @ states.alpha[..., None])[..., 0]
    v = torch.linalg.solve_triangular(states.L, k_star.transpose(-1, -2), upper=False)  # (M, N, m)
    var = params.scale[:, None] - torch.sum(v * v, dim=-2)
    return mean, torch.clamp(var, min=1e-10)


def stack_states(states: "list[GPState]") -> GPState:
    """One GPState whose fields carry a leading axis over ``states`` (the
    reference's ``jax.tree.map(jnp.stack, ...)``)."""
    return GPState(
        params=GPParams(*(torch.stack([s.params[i] for s in states]) for i in range(3))),
        **{f: torch.stack([getattr(s, f) for s in states]) for f in GPState._fields if f != "params"},
    )


# ------------------------------------------------------------ the host fit


def _fit_kernel_params(starts, X, y, cat_mask, mask, minimum_noise: float) -> torch.Tensor:
    """Batched multi-start MAP fit of the host path (the reference's
    ``_fit_kernel_params_jit``): the fused programs' fit with the
    reference's host budget, 100 L-BFGS iterations and a 16-step line
    search in the box [-15, 15]; returns the winning raw vector."""
    from optuna_tpu_torch.gp.fused import _fit_params

    raw, _, _ = _fit_params(starts, X, y, cat_mask, mask, minimum_noise, 100, max_ls=16)
    return raw


def _finalize_state(raw, X, y, cat_mask, mask, minimum_noise: float) -> tuple[GPState, int]:
    """The posterior state at ``raw``, factored on the jitter ladder (the
    rung is the ``gp.ladder_rung`` stat)."""
    from optuna_tpu_torch.gp.fused import _state_for

    with torch.no_grad():
        return _state_for(params_from_raw(raw, X.shape[-1], minimum_noise), X, y, cat_mask, mask)


def kernel_param_starts(d: int, warm_start_raw, n_restarts: int, seed: int) -> np.ndarray:
    """(S, d+2) starts of the host fits: the default first, the warm start
    second, then ``RandomState(seed)`` jitter around the default."""
    default = np.zeros(d + 2, dtype=np.float32)
    default[d + 1] = np.log(1e-2)  # noise; inv_sq_ls = scale = 1
    starts = [default]
    if warm_start_raw is not None:
        starts.append(np.asarray(warm_start_raw, dtype=np.float32))
    rng = np.random.RandomState(seed)
    while len(starts) < n_restarts:
        starts.append(default + rng.normal(0, 1.0, size=d + 2).astype(np.float32))
    return np.stack(starts)


def padded(a: np.ndarray, rows: int) -> np.ndarray:
    """float32 copy of ``a`` padded with zeros to ``rows`` leading rows."""
    out = np.zeros((rows,) + a.shape[1:], dtype=np.float32)
    out[: len(a)] = a
    return out


def upload(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)


def fit_gp(
    X: np.ndarray,
    y: np.ndarray,
    is_categorical: np.ndarray,
    warm_start_raw: np.ndarray | None = None,
    minimum_noise: float = DEFAULT_MINIMUM_NOISE_VAR,
    n_restarts: int = 4,
    seed: int = 0,
    counts: np.ndarray | None = None,
    n_exact_max: int | None = None,
    n_inducing: int | None = None,
    device: "str | torch.device | None" = None,
) -> tuple[GPState, np.ndarray, dict]:
    """Fit kernel params by MAP (MLL + priors) with batched multi-start
    L-BFGS; return the fitted state on ``device``, the raw log-params for
    warm starts and ``{"gp.ladder_rung": rung}``. The default start is
    always in the batch, so the reference's retry with defaults is free.
    ``counts`` rides in the mask (a row standing for k duplicates).

    Above ``n_exact_max`` rows (default
    :data:`optuna_tpu_torch.gp.sparse.N_EXACT_MAX`) the fit hands off to
    :func:`optuna_tpu_torch.gp.sparse.fit_gp_sparse`, a host size check."""
    from optuna_tpu_torch._device import resolve_device
    from optuna_tpu_torch.gp import sparse as _sparse

    dev = resolve_device(device)
    n, d = X.shape
    limit = _sparse.N_EXACT_MAX if n_exact_max is None else int(n_exact_max)
    if n > limit:
        return _sparse.fit_gp_sparse(
            X, y, is_categorical, warm_start_raw, minimum_noise, n_restarts, seed, counts,
            n_inducing=_sparse.N_INDUCING_MAX if n_inducing is None else int(n_inducing),
            device=dev,
        )
    N = _bucket(n)
    starts = upload(kernel_param_starts(d, warm_start_raw, n_restarts, seed), dev)
    Xp, yp = upload(padded(np.asarray(X), N), dev), upload(padded(np.asarray(y), N), dev)
    mask = upload(padded(np.ones(n) if counts is None else np.asarray(counts), N), dev)
    cat_mask = upload(np.asarray(is_categorical), dev, torch.bool)
    raw = _fit_kernel_params(starts, Xp, yp, cat_mask, mask, float(minimum_noise))
    state, rung = _finalize_state(raw, Xp, yp, cat_mask, mask, float(minimum_noise))
    return state, raw.detach().cpu().numpy(), {"gp.ladder_rung": rung}
