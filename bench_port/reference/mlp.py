"""Config #5's trainer in plain PyTorch, one trial at a time: a 784-32-10
ReLU network, its initial weights scaled by the trial's ``init_scale``,
trained by full-batch SGD at the trial's ``lr`` on the mean cross-entropy,
and the trial's value, the mean cross-entropy after the last step.

Run in float32 with TF32 off it is the reference; with TF32 on, the
lower-precision control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def train_one(
    base: dict[str, torch.Tensor], x: torch.Tensor, labels: torch.Tensor, lr: float, init_scale: float, steps: int
) -> float:
    """The final loss of one trial."""
    params = {k: (v * init_scale).clone().requires_grad_(True) for k, v in base.items()}

    def loss_of(p):
        h = torch.relu(x @ p["w1"] + p["b1"])
        return F.cross_entropy(h @ p["w2"] + p["b2"], labels)

    for _ in range(steps):
        grads = torch.autograd.grad(loss_of(params), list(params.values()))
        with torch.no_grad():
            params = {k: (v - lr * g).requires_grad_(True) for (k, v), g in zip(params.items(), grads)}
    with torch.no_grad():
        return float(loss_of(params))
