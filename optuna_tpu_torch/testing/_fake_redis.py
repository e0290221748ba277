"""Minimal in-process Redis stand-in for exercising JournalRedisBackend (port
of ``optuna_tpu/testing/_fake_redis.py``).

The image ships neither a Redis server nor the ``redis``/``fakeredis``
packages, so this shim implements exactly the client surface the backend
touches — ``lrange``, ``rpush`` (via pipeline), ``set``, ``get`` — over a
process-global store keyed by URL: two clients built from the same URL see
the same data, like two connections to one server. Thread-safe, because the
backend is used from multi-worker tests.
"""

from __future__ import annotations

import threading
from typing import Any

_SERVERS: dict[str, "_FakeServer"] = {}
_SERVERS_LOCK = threading.Lock()


class _FakeServer:
    def __init__(self) -> None:
        self.lists: dict[str, list[bytes]] = {}
        self.keys: dict[str, bytes] = {}
        self.lock = threading.Lock()


class _FakePipeline:
    def __init__(self, server: _FakeServer) -> None:
        self._server = server
        self._ops: list[tuple[str, bytes]] = []

    def __enter__(self) -> "_FakePipeline":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass

    def rpush(self, key: str, value: str | bytes) -> None:
        data = value.encode() if isinstance(value, str) else value
        self._ops.append((key, data))

    def execute(self) -> None:
        with self._server.lock:
            for key, data in self._ops:
                self._server.lists.setdefault(key, []).append(data)
        self._ops = []


class FakeRedis:
    """Drop-in for ``redis.Redis`` within JournalRedisBackend's usage."""

    def __init__(self, server: _FakeServer) -> None:
        self._server = server

    @classmethod
    def from_url(cls, url: str) -> "FakeRedis":
        with _SERVERS_LOCK:
            server = _SERVERS.setdefault(url, _FakeServer())
        return cls(server)

    def lrange(self, key: str, start: int, end: int) -> list[bytes]:
        with self._server.lock:
            items = self._server.lists.get(key, [])
            if end == -1:
                return list(items[start:])
            return list(items[start : end + 1])

    def pipeline(self) -> _FakePipeline:
        return _FakePipeline(self._server)

    def set(self, key: str, value: bytes) -> None:
        with self._server.lock:
            self._server.keys[key] = value

    def get(self, key: str) -> bytes | None:
        with self._server.lock:
            return self._server.keys.get(key)


def flush_all() -> None:
    """Drop every fake server (test isolation)."""
    with _SERVERS_LOCK:
        _SERVERS.clear()
