"""Tunable MLP classifier, the model behind BASELINE config #5 (256
parallel MLP trials) (port of ``optuna_tpu/models/mlp.py``).

Plain torch: the matrix products are ``torch.matmul`` (the reference's run
outside any Pallas kernel too), the gradient is ``torch.autograd``, and
``train_mlp`` is a Python loop of ``n_steps`` SGD steps where the
reference scans them in one jit program.

Every function also takes a **batch of networks**: parameters with one
leading trial axis (``w1`` of shape ``(B, in, hidden)``, ``b1`` of shape
``(B, hidden)``) and a learning rate of shape ``(B,)``. The batch is
trained by one autograd call over the sum of the per-trial losses, which
gives each trial its own gradient, since the trials share no parameter:
the counterpart of the reference's ``jax.vmap(value_and_grad(...))``.
:func:`train_scaled_batch` is config #5's batched objective; with
:func:`cross_entropy_onehot` for its loss it is the same training in the
form ``bench.py``'s sharded loop writes it (one-hot labels,
``logsumexp``), in operations that also run on ``DTensor`` s, so that one
function serves a ``ShardedObjective`` and its mesh-less twin.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch


class MLPParams(NamedTuple):
    w1: torch.Tensor  # ([B,] in, hidden)
    b1: torch.Tensor  # ([B,] hidden)
    w2: torch.Tensor  # ([B,] hidden, out)
    b2: torch.Tensor  # ([B,] out)


def init_mlp(generator: torch.Generator, n_in: int, n_hidden: int, n_out: int) -> MLPParams:
    """He-scaled normal weights and zero biases, drawn from ``generator`` on
    its device. JAX's key stream cannot be matched: tests carry the
    reference's weights across with :func:`mlp_params_from_numpy`."""
    device = generator.device
    scale1 = (2.0 / n_in) ** 0.5
    scale2 = (2.0 / n_hidden) ** 0.5
    return MLPParams(
        w1=torch.randn((n_in, n_hidden), generator=generator, device=device) * scale1,
        b1=torch.zeros(n_hidden, device=device),
        w2=torch.randn((n_hidden, n_out), generator=generator, device=device) * scale2,
        b2=torch.zeros(n_out, device=device),
    )


def mlp_params_from_numpy(params: "Mapping[str, np.ndarray] | tuple", device: "str | torch.device") -> MLPParams:
    """The reference's ``MLPParams`` (or a ``{"w1": ..., ...}`` dict of
    arrays, as ``bench.py::_mlp_problem`` returns) as the port's float32
    tensors on ``device``."""
    if not isinstance(params, Mapping):
        params = dict(zip(MLPParams._fields, params))
    return MLPParams(
        *(torch.as_tensor(np.array(params[name], dtype=np.float32), device=device) for name in MLPParams._fields)
    )


def mlp_forward(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """Logits of shape ``([B,] N, out)`` for inputs ``x`` of shape ``(N, in)``."""
    h = torch.relu(torch.matmul(x, params.w1) + params.b1.unsqueeze(-2))
    return torch.matmul(h, params.w2) + params.b2.unsqueeze(-2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the ``N`` examples (log-softmax, then the
    labels' entries gathered): a scalar, or one value a trial."""
    logp = torch.log_softmax(logits, dim=-1)
    index = labels.long().unsqueeze(-1).expand(*logp.shape[:-1], 1)
    return -torch.gather(logp, -1, index).squeeze(-1).mean(dim=-1)


def _per_param(lr: torch.Tensor, p: torch.Tensor, batched: bool) -> torch.Tensor:
    return lr.reshape(lr.shape + (1,) * (p.dim() - lr.dim())) if batched else lr


def cross_entropy_onehot(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against one-hot label rows, ``logsumexp`` less the
    labels' logits (``bench.py::_sharded_mlp_objective``): a scalar, or one
    value a trial. Also for ``DTensor`` s, which have no ``gather`` rule."""
    return (torch.logsumexp(logits, dim=-1) - (logits * onehot).sum(dim=-1)).mean(dim=-1)


Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def sgd_step(
    params: MLPParams, x: torch.Tensor, y: torch.Tensor, lr: "torch.Tensor | float", loss: Loss = cross_entropy
) -> tuple[MLPParams, torch.Tensor]:
    """One full-batch SGD step on ``loss(logits, y)``; returns the new
    parameters and the loss before the step (as the reference's
    ``value_and_grad``)."""
    lr = torch.as_tensor(lr, dtype=params.w1.dtype, device=params.w1.device)
    batched = params.w1.dim() == 3
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in params]
        value = loss(mlp_forward(MLPParams(*leaves), x), y)
        grads = torch.autograd.grad(value.sum(), leaves)
    with torch.no_grad():
        new = MLPParams(*(p - _per_param(lr, p, batched) * g for p, g in zip(leaves, grads)))
    return new, value.detach()


def train_mlp(
    params: MLPParams,
    x: torch.Tensor,
    y: torch.Tensor,
    lr: "torch.Tensor | float",
    n_steps: int = 20,
    loss: Loss = cross_entropy,
) -> tuple[MLPParams, torch.Tensor]:
    """``n_steps`` of full-batch SGD; returns the parameters and the loss
    of the last step (before its update), as the reference's scan does."""
    value = None
    for _ in range(n_steps):
        params, value = sgd_step(params, x, y, lr, loss)
    return params, value


def train_scaled_batch(
    base: MLPParams,
    x: torch.Tensor,
    y: torch.Tensor,
    lr: torch.Tensor,
    init_scale: torch.Tensor,
    n_steps: int,
    loss: Loss = cross_entropy,
) -> torch.Tensor:
    """Config #5's batched objective (``bench.py::run_ours_mlp_vectorized``):
    trial ``i`` trains ``base * init_scale[i]`` for ``n_steps`` SGD steps at
    rate ``lr[i]`` and returns its final loss. Shape ``(B,)``.

    With ``loss=cross_entropy_onehot`` and one-hot rows for ``y`` it is the
    sharded loop's objective (``bench.py::_sharded_mlp_objective``); every
    operand may then be a ``DTensor`` on one mesh (``base`` sharded by
    partition rules, ``lr``/``init_scale`` along the batch), and the
    operations are the same either way."""
    scale = init_scale.to(base.w1.dtype)
    start = MLPParams(*(p.unsqueeze(0) * scale.reshape((-1,) + (1,) * p.dim()) for p in base))
    params, _ = train_mlp(start, x, y, lr.to(base.w1.dtype), n_steps, loss)
    with torch.no_grad():
        return loss(mlp_forward(params, x), y)
