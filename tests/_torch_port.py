"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch


def t32(a, dtype=torch.float32) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor."""
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype)


def np64(t) -> np.ndarray:
    """tensor or JAX array -> float64 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


@pytest.fixture
def cuda_device() -> torch.device:
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)
