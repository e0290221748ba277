"""Config #5's training, counted from its shapes: N examples of n_in
inputs, a hidden layer of n_hidden, n_out classes, ``sgd_steps`` full-batch
steps and one final forward pass a trial.

FLOPs are those of the matrix products (two a multiply-add): a forward
pass is ``2 N (n_in h + h n_out)``; a backward pass takes the gradients of
both weight matrices and of the hidden activations, ``2 N (n_in h + 2 h
n_out)`` (the inputs need no gradient). Biases, ReLU, softmax and the SGD
update are elementwise and left out. Bytes are the least a batch must move:
the examples and labels read once, the trials' weights read and their
losses written once.
"""

from __future__ import annotations


def _shapes(config: dict) -> tuple[int, int, int, int, int]:
    return (int(config["n_examples"]), int(config["n_in"]), int(config["n_hidden"]),
            int(config["n_out"]), int(config["sgd_steps"]))


def train_flops(config: dict) -> float:
    """FLOPs of one trial: ``sgd_steps`` forward and backward passes and a
    final forward pass."""
    n, n_in, h, n_out, steps = _shapes(config)
    forward = 2 * n * (n_in * h + h * n_out)
    backward = 2 * n * (n_in * h + 2 * h * n_out)
    return float(steps * (forward + backward) + forward)


def batch_bytes(config: dict, batch: int) -> float:
    """Bytes a batch of ``batch`` trials must move at least (float32 data,
    int64 labels)."""
    n, n_in, h, n_out, _ = _shapes(config)
    params = n_in * h + h + h * n_out + n_out
    return float(4 * n * n_in + 8 * n + 4 * params + batch * (4 * 2 + 4))
