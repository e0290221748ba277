"""Acquisition functions as pure ``(data, x) -> value`` functions (port of
``optuna_tpu/gp/acqf.py``): LogEI, qLogEI over fantasies of running
trials, LogPI, UCB/LCB, LogEHVI and the constrained wrapper, with the
``ACQF_VALUE_FNS`` registry the optimizers look names up in.

Each acquisition is a ``NamedTuple`` of data plus a value function over a
query batch x (m, d). Where the reference ``vmap``s over stacked states
(one GP per objective or constraint), the port queries the stacked tensors
at once (:func:`~optuna_tpu_torch.gp.gp.posterior_stacked`).

Objective convention: single-objective GPs fit **maximization**-standardized
targets (EI improves upward); multi-objective EHVI works in
**minimization**-normalized space.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from optuna_tpu_torch.gp.gp import GPState, matern52, posterior, posterior_stacked
from optuna_tpu_torch.ops.special import log_h, log_ndtr

# ----------------------------------------------------------------------- LogEI


class LogEIData(NamedTuple):
    state: GPState
    cat_mask: torch.Tensor
    best: torch.Tensor  # () incumbent (max over observed, incl. liar values)
    stabilizing_noise: torch.Tensor


def logei_value(data: LogEIData, x: torch.Tensor) -> torch.Tensor:
    """log E[(f(x) - best)+] for query batch x (m, d)."""
    mean, var = posterior(data.state, x, data.cat_mask)
    sigma = torch.sqrt(var + data.stabilizing_noise)
    z = (mean - data.best) / sigma
    return torch.log(sigma) + log_h(z)


# ---------------------------------------------------------------------- qLogEI


class QLogEIData(NamedTuple):
    """Fantasy-conditioned LogEI: the GP is extended with the running
    trials' params and F QMC-sampled fantasy outcomes. X/L are shared across
    fantasies; only alpha varies."""

    state: GPState  # X includes the running trials' rows
    cat_mask: torch.Tensor
    alphas: torch.Tensor  # (F, N) per-fantasy K^{-1} y_f
    best: torch.Tensor  # (F,) per-fantasy incumbent
    stabilizing_noise: torch.Tensor


def qlogei_value(data: QLogEIData, x: torch.Tensor) -> torch.Tensor:
    st = data.state
    k_star = matern52(x, st.X, st.params, data.cat_mask)  # (m, N)
    means = k_star @ data.alphas.T  # (m, F)
    v = torch.linalg.solve_triangular(st.L, k_star.T, upper=False)
    var = torch.clamp(st.params.scale - torch.sum(v * v, dim=0), min=1e-10)
    sigma = torch.sqrt(var + data.stabilizing_noise)[:, None]  # (m, 1)
    z = (means - data.best[None, :]) / sigma
    log_ei_f = torch.log(sigma) + log_h(z)  # (m, F)
    return torch.logsumexp(log_ei_f, dim=1) - math.log(float(data.alphas.shape[0]))


# ----------------------------------------------------------------------- LogPI


class LogPIData(NamedTuple):
    state: GPState
    cat_mask: torch.Tensor
    best: torch.Tensor
    stabilizing_noise: torch.Tensor


def logpi_value(data: LogPIData, x: torch.Tensor) -> torch.Tensor:
    """log P(f(x) > best)."""
    mean, var = posterior(data.state, x, data.cat_mask)
    sigma = torch.sqrt(var + data.stabilizing_noise)
    return log_ndtr((mean - data.best) / sigma)


# --------------------------------------------------------------------- UCB/LCB


class UCBData(NamedTuple):
    state: GPState
    cat_mask: torch.Tensor
    beta: torch.Tensor


def ucb_value(data: UCBData, x: torch.Tensor) -> torch.Tensor:
    mean, var = posterior(data.state, x, data.cat_mask)
    return mean + torch.sqrt(data.beta * var)


def lcb_value(data: UCBData, x: torch.Tensor) -> torch.Tensor:
    mean, var = posterior(data.state, x, data.cat_mask)
    return mean - torch.sqrt(data.beta * var)


# -------------------------------------------------------------------- LogEHVI


class LogEHVIData(NamedTuple):
    """QMC-sample EHVI over a disjoint box decomposition of the
    non-dominated region. Minimization convention throughout."""

    states: GPState  # stacked over objectives: leading axis M
    cat_mask: torch.Tensor
    box_lowers: torch.Tensor  # (K, M)
    box_uppers: torch.Tensor  # (K, M)
    qmc_z: torch.Tensor  # (S, M) standard-normal QMC draws
    stabilizing_noise: torch.Tensor


def logehvi_value(data: LogEHVIData, x: torch.Tensor) -> torch.Tensor:
    means, variances = posterior_stacked(data.states, x, data.cat_mask)  # (M, m)
    sigmas = torch.sqrt(variances + data.stabilizing_noise)
    # Posterior QMC samples: (S, M, m)
    y = means[None, :, :] + data.qmc_z[:, :, None] * sigmas[None, :, :]
    # Contribution of sample y to box k: prod_j ( u_kj - max(y_j, l_kj) )+
    yk = torch.maximum(y[:, None, :, :], data.box_lowers[None, :, :, None])  # (S, K, M, m)
    edge = torch.clamp(data.box_uppers[None, :, :, None] - yk, min=0.0)
    hvi = torch.sum(torch.prod(edge, dim=2), dim=1)  # (S, m)
    ehvi = torch.mean(hvi, dim=0)  # (m,)
    return torch.log(ehvi + 1e-37)


# ---------------------------------------------------------------- constrained


class ConstrainedData(NamedTuple):
    """Any base acquisition + sum of constraint log-feasibility:
    base(x) + sum_c log P(c(x) <= thr_c). One wrapper serves
    logei/qlogei/logehvi; the base data rides along."""

    base: object  # the wrapped acquisition's data
    constraint_states: GPState  # stacked: leading axis C
    constraint_cat_mask: torch.Tensor
    constraint_thresholds: torch.Tensor  # (C,) in each constraint's standardized space
    stabilizing_noise: torch.Tensor


def _log_feasibility(data: ConstrainedData, x: torch.Tensor) -> torch.Tensor:
    mean, var = posterior_stacked(data.constraint_states, x, data.constraint_cat_mask)  # (C, m)
    sigma = torch.sqrt(var + data.stabilizing_noise)
    log_feas = log_ndtr((data.constraint_thresholds[:, None] - mean) / sigma)  # log P(c <= thr)
    return torch.sum(log_feas, dim=0)


def _make_constrained(base_fn):
    def value(data: ConstrainedData, x: torch.Tensor) -> torch.Tensor:
        return base_fn(data.base, x) + _log_feasibility(data, x)

    return value


ACQF_VALUE_FNS = {
    "logei": logei_value,
    "qlogei": qlogei_value,
    "logpi": logpi_value,
    "ucb": ucb_value,
    "lcb": lcb_value,
    "logehvi": logehvi_value,
}
for _base in ("logei", "qlogei", "logehvi"):
    ACQF_VALUE_FNS[f"constrained_{_base}"] = _make_constrained(ACQF_VALUE_FNS[_base])


def data_device(data) -> torch.device:
    """The device an acquisition's data lives on."""
    if isinstance(data, ConstrainedData):
        return data.constraint_cat_mask.device
    return data.cat_mask.device
