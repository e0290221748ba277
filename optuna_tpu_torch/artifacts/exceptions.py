"""Artifact exceptions (reference ``optuna/artifacts/exceptions.py``)."""

from optuna_tpu_torch.artifacts._backends import ArtifactNotFound

__all__ = ["ArtifactNotFound"]
