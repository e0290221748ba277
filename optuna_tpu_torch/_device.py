"""Device resolution for the port's numerical entry points.

Every numerical function takes an explicit ``device``. ``None`` means the
card: the port runs on CUDA unless the caller asks for the CPU by name, and
with no GPU present it raises rather than slipping onto the CPU.

Precision is float32 on the device, as in the reference. TF32 would keep
only about three decimal digits in float32 matrix products and
convolutions, so both switches are turned off when this module is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → ``cuda``; any CUDA device → checked to exist; ``"cpu"`` → CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "optuna_tpu_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {dev!r}: use 'cuda' or 'cpu'.")
    return dev
