"""Special functions for the GP acquisition and TPE (port of ``optuna_tpu/ops/special.py``).

Same piecewise closed forms as the reference, written with torch ops so the
port and the reference round alike.
"""

from __future__ import annotations

import math

import torch

_SQRT_PI = 1.7724538509055159
_SQRT_2 = 1.4142135623730951
_LOG_SQRT_2PI = 0.9189385332046727


def erfcx(x: torch.Tensor) -> torch.Tensor:
    """Scaled complementary error function ``exp(x^2) erfc(x)`` for x >= 0.

    Direct product below x=4; 6-term asymptotic series above (relative error
    ~1e-5, inside f32 tolerance). Negative inputs are clamped to 0.
    """
    x = torch.clamp(x, min=0.0)
    small = x <= 4.0
    xs = torch.where(small, x, torch.ones_like(x))
    direct = torch.exp(xs * xs) * torch.special.erfc(xs)

    xl = torch.where(small, torch.full_like(x, 4.0), x)
    inv2 = 1.0 / (2.0 * xl * xl)
    # 1 - 1!!*t + 3!!*t^2 - 5!!*t^3 + 7!!*t^4 - 9!!*t^5, t = 1/(2x^2)
    series = 1.0 + inv2 * (-1.0 + inv2 * (3.0 + inv2 * (-15.0 + inv2 * (105.0 - inv2 * 945.0))))
    tail = series / (xl * _SQRT_PI)
    return torch.where(small, direct, tail)


def standard_norm_pdf(z: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * z * z - _LOG_SQRT_2PI)


def log_h(z: torch.Tensor) -> torch.Tensor:
    """``log( phi(z) + z * Phi(z) )`` — the stable log-EI core.

    Direct evaluation for z > -1; for the left tail rewrite via the Mills
    ratio ``Phi(z)/phi(z) = sqrt(pi/2) * erfcx(-z/sqrt(2))`` so no
    catastrophic cancellation occurs. Both branches see safe inputs, so the
    unselected one never feeds NaN into the gradient.
    """
    small = z < -1.0
    zs = torch.where(small, torch.zeros_like(z), z)
    direct = torch.log(standard_norm_pdf(zs) + zs * torch.special.ndtr(zs))

    zt = torch.where(small, z, torch.full_like(z, -2.0))
    r = math.sqrt(math.pi / 2.0) * erfcx(-zt / _SQRT_2)  # Phi(z)/phi(z) > 0
    # z*r is in (-1, 0): log1p stays finite; add log phi(z).
    tail = -0.5 * zt * zt - _LOG_SQRT_2PI + torch.log1p(zt * r)
    return torch.where(small, tail, direct)


def logsumexp(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.logsumexp``: a slice of all ``-inf`` gives ``-inf`` (not NaN),
    as ``jax.scipy.special.logsumexp`` does; TPE's padded mixture components
    carry ``-inf`` log weights."""
    return torch.logsumexp(a, dim=dim)


def log_ndtr(z: torch.Tensor) -> torch.Tensor:
    """``log Phi(z)``, stable in both tails and differentiable: the
    reference takes ``jax.scipy.special.log_ndtr``; this is PyTorch's own
    special function of the same name (no kernel of the repo)."""
    return torch.special.log_ndtr(z)
