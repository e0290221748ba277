"""Redis journal backend (port of ``optuna_tpu/storages/journal/_redis.py``;
reference ``optuna/storages/journal/_redis.py:20``).

Requires the ``redis`` client package; gated import so the rest of the
journal stack works without it.
"""

from __future__ import annotations

import json
from typing import Any

from optuna_tpu_torch.storages.journal._base import BaseJournalBackend
from optuna_tpu_torch.storages.journal._file import frame_snapshot, unframe_snapshot


class JournalRedisBackend(BaseJournalBackend):
    """Journal as a Redis list plus a snapshot key."""

    def __init__(
        self,
        url: str,
        use_cluster: bool = False,
        prefix: str = "optuna_tpu",
        client: Any | None = None,
    ) -> None:
        """``client`` injects a pre-built Redis-compatible client (tests use
        :class:`optuna_tpu_torch.testing._fake_redis.FakeRedis`); otherwise the
        ``redis`` package is required."""
        self._url = url
        self._prefix = prefix
        if client is not None:
            self._redis = client
            return
        try:
            import redis
        except ImportError as e:  # pragma: no cover - environment-dependent
            raise ImportError(
                "JournalRedisBackend requires the `redis` package; "
                "install it or use JournalFileBackend."
            ) from e
        self._redis = redis.Redis.from_url(url)

    def read_logs(self, log_number_from: int) -> list[dict[str, Any]]:
        raw = self._redis.lrange(f"{self._prefix}:logs", log_number_from, -1)
        return [json.loads(r) for r in raw]

    def append_logs(self, logs: list[dict[str, Any]]) -> None:
        with self._redis.pipeline() as pipe:
            for log in logs:
                pipe.rpush(f"{self._prefix}:logs", json.dumps(log, separators=(",", ":")))
            pipe.execute()

    def save_snapshot(self, snapshot: bytes) -> None:
        # Same CRC32 frame as the file backend: the checksum is verified
        # before any byte reaches pickle, whatever transport stored it.
        self._redis.set(f"{self._prefix}:snapshot", frame_snapshot(snapshot))

    def load_snapshot(self) -> bytes | None:
        data = self._redis.get(f"{self._prefix}:snapshot")
        return unframe_snapshot(data, source=f"{self._prefix}:snapshot")

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        del state["_redis"]
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        import redis

        self.__dict__.update(state)
        self._redis = redis.Redis.from_url(self._url)
