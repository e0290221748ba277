"""LogEI acquisition (port of ``optuna_tpu/gp/acqf.py``: ``LogEIData`` and
``logei_value``; the qLogEI, LogPI, UCB, EHVI and constrained variants come
with later slices).

Objective convention: the GP fits **maximization**-standardized targets, so
EI improves upward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from optuna_tpu_torch.gp.gp import GPState, posterior
from optuna_tpu_torch.ops.special import log_h


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
