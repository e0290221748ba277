"""Artifact store backends and the upload/download API."""

from __future__ import annotations

import dataclasses
import json
import mimetypes
import os
import shutil
import time
import uuid
from typing import TYPE_CHECKING, Any, BinaryIO

from optuna_tpu_torch.exceptions import OptunaTPUError
from optuna_tpu_torch.logging import get_logger

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._frozen import FrozenTrial
    from optuna_tpu_torch.trial._trial import Trial

_logger = get_logger(__name__)

ARTIFACTS_ATTR_PREFIX = "artifacts:"


class ArtifactNotFound(OptunaTPUError):
    pass


@dataclasses.dataclass
class ArtifactMeta:
    artifact_id: str
    filename: str
    mimetype: str
    encoding: str | None


class FileSystemArtifactStore:
    """Local/NFS directory store (reference ``_filesystem.py``)."""

    def __init__(self, base_path: str) -> None:
        self._base_path = base_path
        os.makedirs(base_path, exist_ok=True)

    def _path(self, artifact_id: str) -> str:
        if os.sep in artifact_id or "/" in artifact_id:
            raise ValueError(f"Invalid artifact_id {artifact_id!r}.")
        return os.path.join(self._base_path, artifact_id)

    def open_reader(self, artifact_id: str) -> BinaryIO:
        try:
            return open(self._path(artifact_id), "rb")
        except FileNotFoundError as e:
            raise ArtifactNotFound(f"Artifact {artifact_id} not found.") from e

    def write(self, artifact_id: str, content_body: BinaryIO) -> None:
        with open(self._path(artifact_id), "wb") as f:
            shutil.copyfileobj(content_body, f)

    def remove(self, artifact_id: str) -> None:
        try:
            os.remove(self._path(artifact_id))
        except FileNotFoundError as e:
            raise ArtifactNotFound(f"Artifact {artifact_id} not found.") from e


class Boto3ArtifactStore:
    """S3-compatible store; requires boto3 (gated import)."""

    def __init__(self, bucket_name: str, client: Any = None, *, avoid_buf_copy: bool = False) -> None:
        try:
            import boto3
        except ImportError as e:  # pragma: no cover
            raise ImportError("Boto3ArtifactStore requires the `boto3` package.") from e
        self._bucket = bucket_name
        self._client = client or boto3.client("s3")

    def open_reader(self, artifact_id: str) -> BinaryIO:
        try:
            obj = self._client.get_object(Bucket=self._bucket, Key=artifact_id)
        except self._client.exceptions.NoSuchKey as e:  # pragma: no cover
            raise ArtifactNotFound(f"Artifact {artifact_id} not found.") from e
        return obj["Body"]

    def write(self, artifact_id: str, content_body: BinaryIO) -> None:
        self._client.upload_fileobj(content_body, self._bucket, artifact_id)

    def remove(self, artifact_id: str) -> None:
        self._client.delete_object(Bucket=self._bucket, Key=artifact_id)


class GCSArtifactStore:
    """Google Cloud Storage store; requires google-cloud-storage (gated)."""

    def __init__(self, bucket_name: str, client: Any = None) -> None:
        try:
            from google.cloud import storage
        except ImportError as e:  # pragma: no cover
            raise ImportError("GCSArtifactStore requires `google-cloud-storage`.") from e
        self._client = client or storage.Client()
        self._bucket = self._client.bucket(bucket_name)

    def open_reader(self, artifact_id: str) -> BinaryIO:
        import io

        blob = self._bucket.blob(artifact_id)
        if not blob.exists():
            raise ArtifactNotFound(f"Artifact {artifact_id} not found.")
        return io.BytesIO(blob.download_as_bytes())

    def write(self, artifact_id: str, content_body: BinaryIO) -> None:
        self._bucket.blob(artifact_id).upload_from_file(content_body)

    def remove(self, artifact_id: str) -> None:
        self._bucket.blob(artifact_id).delete()


class Backoff:
    """Exponential-backoff wrapper around any store (reference ``_backoff.py:19``)."""

    def __init__(
        self,
        backend: Any,
        *,
        max_retries: int = 10,
        multiplier: float = 2.0,
        min_delay: float = 0.1,
        max_delay: float = 30.0,
    ) -> None:
        self._backend = backend
        self._max_retries = max_retries
        self._multiplier = multiplier
        self._min_delay = min_delay
        self._max_delay = max_delay

    def _retry(self, fn, *args):
        delay = self._min_delay
        for attempt in range(self._max_retries):
            try:
                return fn(*args)
            except ArtifactNotFound:
                raise
            except Exception:  # graphlint: ignore[PY001] -- retry wrapper over pluggable backends (boto3/fs/...); their transient error types are not knowable here
                if attempt == self._max_retries - 1:
                    raise
                time.sleep(delay)
                delay = min(delay * self._multiplier, self._max_delay)

    def open_reader(self, artifact_id: str) -> BinaryIO:
        return self._retry(self._backend.open_reader, artifact_id)

    def write(self, artifact_id: str, content_body: BinaryIO) -> None:
        if not content_body.seekable():
            # A consumed stream cannot be replayed; retrying would silently
            # persist a truncated artifact. Fail loudly on the first error.
            return self._backend.write(artifact_id, content_body)
        start = content_body.tell()

        def _write(aid, body):
            body.seek(start)
            return self._backend.write(aid, body)

        return self._retry(_write, artifact_id, content_body)

    def remove(self, artifact_id: str) -> None:
        return self._retry(self._backend.remove, artifact_id)


def upload_artifact(
    *,
    artifact_store: Any,
    file_path: str,
    study_or_trial: "Trial | FrozenTrial | Study",
    storage: Any = None,
    mimetype: str | None = None,
    encoding: str | None = None,
) -> str:
    """Upload a file, record its metadata in system attrs, return artifact_id
    (reference ``_upload.py:58``)."""
    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._frozen import FrozenTrial
    from optuna_tpu_torch.trial._trial import Trial

    filename = os.path.basename(file_path)
    artifact_id = str(uuid.uuid4())
    guessed_mimetype, guessed_encoding = mimetypes.guess_type(filename)
    meta = ArtifactMeta(
        artifact_id=artifact_id,
        filename=filename,
        mimetype=mimetype or guessed_mimetype or "application/octet-stream",
        encoding=encoding or guessed_encoding,
    )
    with open(file_path, "rb") as f:
        artifact_store.write(artifact_id, f)

    attr_key = ARTIFACTS_ATTR_PREFIX + artifact_id
    value = json.dumps(dataclasses.asdict(meta))
    if isinstance(study_or_trial, Trial):
        study_or_trial.storage.set_trial_system_attr(study_or_trial._trial_id, attr_key, value)
    elif isinstance(study_or_trial, FrozenTrial):
        if storage is None:
            raise ValueError("storage is required for FrozenTrial.")
        storage.set_trial_system_attr(study_or_trial._trial_id, attr_key, value)
    elif isinstance(study_or_trial, Study):
        study_or_trial._storage.set_study_system_attr(
            study_or_trial._study_id, attr_key, value
        )
    else:
        raise TypeError(f"Unexpected study_or_trial type {type(study_or_trial)}.")
    return artifact_id


def download_artifact(*, artifact_store: Any, artifact_id: str, file_path: str) -> None:
    with artifact_store.open_reader(artifact_id) as reader, open(file_path, "wb") as f:
        shutil.copyfileobj(reader, f)


def get_all_artifact_meta(
    study_or_trial: "Trial | FrozenTrial | Study", *, storage: Any = None
) -> list[ArtifactMeta]:
    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._trial import Trial

    if isinstance(study_or_trial, Study):
        attrs = study_or_trial.system_attrs
    elif isinstance(study_or_trial, Trial):
        attrs = study_or_trial.system_attrs
    else:
        attrs = study_or_trial.system_attrs
    out = []
    for k, v in attrs.items():
        if k.startswith(ARTIFACTS_ATTR_PREFIX):
            d = json.loads(v)
            out.append(ArtifactMeta(**d))
    return out
