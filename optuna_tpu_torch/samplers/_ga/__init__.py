from optuna_tpu_torch.samplers._ga._base import BaseGASampler

__all__ = ["BaseGASampler"]
