"""Artifact stores: large blobs out-of-band of the trial storage.

Parity target: ``optuna/artifacts/`` — ``ArtifactStore`` protocol
(``_protocol.py:11``), filesystem/S3/GCS backends, exponential ``Backoff``
wrapper (``_backoff.py:19``), ``upload_artifact`` recording
``artifacts:{id}`` JSON metadata in trial/study system attrs (``_upload.py``).
"""

from optuna_tpu_torch.artifacts._backends import (
    ArtifactMeta,
    ArtifactNotFound,
    Backoff,
    Boto3ArtifactStore,
    FileSystemArtifactStore,
    GCSArtifactStore,
    download_artifact,
    get_all_artifact_meta,
    upload_artifact,
)

__all__ = [
    "ArtifactMeta",
    "ArtifactNotFound",
    "Backoff",
    "Boto3ArtifactStore",
    "FileSystemArtifactStore",
    "GCSArtifactStore",
    "download_artifact",
    "get_all_artifact_meta",
    "upload_artifact",
]
