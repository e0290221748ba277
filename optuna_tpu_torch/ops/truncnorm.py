"""Truncated standard normal: ppf / logpdf / log mass, in torch
(port of ``optuna_tpu/ops/truncnorm.py``).

Elementwise and broadcasting, float32 on the device like the reference.
Built from ``torch.special.{log_ndtr, ndtr, ndtri}`` with the reference's
case analysis: the symmetry ``ppf(q; a, b) = -ppf(1-q; -b, -a)`` always
evaluates in the left tail, where ``ndtr`` is well conditioned, and the
inputs of every unselected ``torch.where`` branch are sanitised so no NaN
or Inf leaks through the select.
"""

from __future__ import annotations

import torch

_LOG_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))


def _log_gauss_mass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``log(ndtr(b) - ndtr(a))`` for any placement of [a, b]; ``-inf`` for
    an empty interval (b <= a)."""
    flip = a > 0
    a_, b_ = torch.where(flip, -b, a), torch.where(flip, -a, b)

    # Pure left tail (b_ <= 0): log_ndtr(b) + log1p(-exp(log_ndtr(a) - log_ndtr(b))).
    case_tail = b_ <= 0
    log_ndtr_a = torch.special.log_ndtr(torch.where(case_tail, a_, -1.0))
    log_ndtr_b = torch.special.log_ndtr(torch.where(case_tail, b_, 0.0))
    tail = log_ndtr_b + torch.log1p(-torch.exp(torch.clamp(log_ndtr_a - log_ndtr_b, max=0.0)))

    # The interval straddles 0: log1p(-ndtr(a) - ndtr(-b)).
    central = torch.log1p(
        -torch.special.ndtr(torch.where(case_tail, 0.0, a_))
        - torch.special.ndtr(torch.where(case_tail, 0.0, -b_))
    )
    out = torch.where(case_tail, tail, central)
    return torch.where(b <= a, -torch.inf, out)


def ppf(q: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Percent-point function of the standard normal truncated to [a, b],
    through the side of the interval nearer to -inf."""
    flip = a > 0
    a_, b_ = torch.where(flip, -b, a), torch.where(flip, -a, b)
    q_ = torch.where(flip, 1.0 - q, q)

    log_mass = _log_gauss_mass(a_, b_)
    # log(ndtr(a_) + q_ * mass) = logaddexp(log_ndtr(a_), log(q_) + log_mass)
    log_q = torch.log(torch.clamp(q_, min=torch.finfo(q_.dtype).tiny))
    log_cdf = torch.logaddexp(torch.special.log_ndtr(a_), log_q + log_mass)
    x = torch.special.ndtri(torch.exp(log_cdf))
    x = torch.where(q_ <= 0.0, a_, x)
    x = torch.where(q_ >= 1.0, b_, x)
    x = torch.minimum(torch.maximum(x, a_), b_)
    return torch.where(flip, -x, x)


def logpdf(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log density of the standard normal truncated to [a, b] at x."""
    out = -0.5 * x * x - _LOG_SQRT_2PI - _log_gauss_mass(a, b)
    return torch.where((x < a) | (x > b), -torch.inf, out)


def log_mass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Public alias of the stable log Gaussian interval mass."""
    return _log_gauss_mass(a, b)


def rvs(
    generator: torch.Generator | None,
    a: torch.Tensor,
    b: torch.Tensor,
    loc: "torch.Tensor | float" = 0.0,
    scale: "torch.Tensor | float" = 1.0,
    shape: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Sample via inverse transform; a/b are in standard units. The uniforms
    come from ``generator`` (a ``torch.Generator`` on a/b's device, or None
    for torch's default one) where the reference takes a ``jax.random`` key."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if shape is None:
        shape = torch.broadcast_shapes(a.shape, b.shape)
    dtype = a.dtype if a.is_floating_point() else torch.get_default_dtype()
    q = torch.rand(shape, generator=generator, dtype=dtype, device=a.device)
    return ppf(q, a, b) * scale + loc
