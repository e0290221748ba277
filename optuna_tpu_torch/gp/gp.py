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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from optuna_tpu_torch.gp.prior import log_prior

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
    pos = d2 > 0
    safe = torch.where(pos, d2, torch.ones_like(d2))
    d = torch.where(pos, torch.sqrt(safe), torch.zeros_like(d2))
    sqrt5d = _SQRT5 * d
    scale = params.scale[..., None, None]
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
