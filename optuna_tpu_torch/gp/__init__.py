"""Gaussian-process core of the port (reference ``optuna_tpu/gp``)."""
