from optuna_tpu_torch.samplers._gp.sampler import GPSampler

__all__ = ["GPSampler"]
