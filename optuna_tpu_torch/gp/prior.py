"""Log-priors over GP kernel hyperparameters (port of ``optuna_tpu/gp/prior.py``).

Gamma priors on kernel scale and noise plus a lengthscale prior that keeps
inverse squared lengthscales away from degenerate extremes.
"""

from __future__ import annotations

import torch

DEFAULT_MINIMUM_NOISE_VAR = 1e-5  # f32 floor (reference uses 1e-6 in f64)


def log_prior(
    inv_sq_lengthscales: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Sum of log-prior densities (up to constants), batched over leading dims.

    * inverse squared lengthscales: concentration ~ Gamma-like bump keeping
      them O(1) in normalized space;
    * kernel scale: Gamma(2, 1);
    * noise variance: Gamma(1.1, 30) pushing toward small noise.
    """
    lp_ls = torch.sum(-(0.1 / inv_sq_lengthscales) - 0.1 * inv_sq_lengthscales, dim=-1)
    lp_scale = torch.log(scale) - scale  # Gamma(2, 1) up to const
    lp_noise = 0.1 * torch.log(noise) - 30.0 * noise  # Gamma(1.1, 30) up to const
    return lp_ls + lp_scale + lp_noise
