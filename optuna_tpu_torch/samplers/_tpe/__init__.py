from optuna_tpu_torch.samplers._tpe.sampler import MOTPESampler, TPESampler

__all__ = ["MOTPESampler", "TPESampler"]
