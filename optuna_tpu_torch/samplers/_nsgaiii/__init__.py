from optuna_tpu_torch.samplers._nsgaiii._sampler import NSGAIIISampler

__all__ = ["NSGAIIISampler"]
