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

With plain tensors, integer labels and :func:`cross_entropy`,
:func:`train_scaled_batch` trains in the **wide layout** instead
(:func:`wide_params`, :func:`wide_sgd_step`): every trial's first layer
is one column block of ``w1`` of shape ``(in, B*hidden)``, so a step is
one ``(N, in) @ (in, B*hidden)`` product, the head
(``ops/kernels/mlp_head.py``: the hand-written kernel on the card, its
plain version on the CPU) and one ``X^T @ dH`` product for all trials.
Same arithmetic in the same precision; only the order of summation
differs.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from optuna_tpu_torch.ops.kernels import mlp_head


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
    operations are the same either way.

    Plain tensors with integer labels and ``loss=cross_entropy`` train in
    the wide layout (:func:`wide_sgd_step`), on the CPU in any dtype and on
    the card in float32 at the head kernel's widths; everything else takes
    autograd's batched path."""
    if _wide(base, x, y, lr, init_scale, loss):
        with torch.no_grad():
            params = wide_params(base, init_scale)
            y, lr = y.long(), lr.to(x.dtype)
            z = torch.empty((x.shape[0], params.w1.shape[1]), dtype=x.dtype, device=x.device)
            for _ in range(n_steps):
                wide_sgd_step(params, x, y, lr, z)
            torch.matmul(x, params.w1, out=z)
            return mlp_head.head_loss(z, params.b1, params.w2, params.b2, y)
    scale = init_scale.to(base.w1.dtype)
    start = MLPParams(*(p.unsqueeze(0) * scale.reshape((-1,) + (1,) * p.dim()) for p in base))
    params, _ = train_mlp(start, x, y, lr.to(base.w1.dtype), n_steps, loss)
    with torch.no_grad():
        return loss(mlp_forward(params, x), y)


def _wide(base: MLPParams, x, y, lr, init_scale, loss: Loss) -> bool:
    """Whether :func:`train_scaled_batch` takes the wide layout, from what
    its inputs show: plain tensors (no ``DTensor``), one unbatched network,
    integer labels, :func:`cross_entropy`; on the card float32 at widths
    the head kernel is built for."""
    if loss is not cross_entropy or any(type(t) is not torch.Tensor for t in (*base, x, y, lr, init_scale)):
        return False
    if base.w1.dim() != 2 or y.dim() != 1 or y.is_floating_point() or x.dtype != base.w1.dtype:
        return False
    if x.device.type == "cpu":
        return True
    return x.dtype == torch.float32 and x.device.type == "cuda" and mlp_head.supports(*base.w2.shape)


def wide_params(base: MLPParams, init_scale: torch.Tensor) -> MLPParams:
    """Trial ``i``'s network ``base * init_scale[i]`` for every trial, in the
    wide layout: ``w1`` ``(in, B*hidden)`` with trial ``i`` in columns
    ``i*hidden:(i+1)*hidden``, ``b1`` ``(B, hidden)``, ``w2`` ``(B, hidden,
    out)``, ``b2`` ``(B, out)``. The products are those of the batched
    start, so both layouts begin from the same bits."""
    scale = init_scale.to(base.w1.dtype)
    n_in = base.w1.shape[0]
    return MLPParams(
        w1=(base.w1.unsqueeze(1) * scale.reshape(1, -1, 1)).reshape(n_in, -1),
        b1=base.b1 * scale.reshape(-1, 1),
        w2=base.w2 * scale.reshape(-1, 1, 1),
        b2=base.b2 * scale.reshape(-1, 1),
    )


def wide_sgd_step(
    params: MLPParams, x: torch.Tensor, y: torch.Tensor, lr: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """One full-batch SGD step of every trial of ``params`` (wide layout, see
    :func:`wide_params`), in place, on the cross-entropy against int64
    labels ``y``; returns the losses before the step, ``(B,)``. ``z`` is
    an ``(N, B*hidden)`` buffer: ``X @ W1``, then ``lr * dH`` written over
    it by the head, then ``W1 -= X^T (lr * dH)`` as one in-place product."""
    torch.matmul(x, params.w1, out=z)
    grads = mlp_head.head_step(z, params.b1, params.w2, params.b2, y, lr)
    params.w1.addmm_(x.t(), z, alpha=-1)
    params.w2.sub_(lr.reshape(-1, 1, 1) * grads.w2)
    params.b2.sub_(lr.reshape(-1, 1) * grads.b2)
    params.b1.sub_(lr.reshape(-1, 1) * grads.b1)
    return grads.loss
