"""Deferred imports (reference ``optuna/_imports.py:101,111``)."""

from __future__ import annotations

import importlib
import types
from typing import Any, Iterator
from contextlib import contextmanager


class _DeferredImportExceptionContextManager:
    """Collects ImportErrors so optional deps degrade to clear messages."""

    def __init__(self) -> None:
        self._deferred: tuple[Exception, str] | None = None

    @contextmanager
    def _guard(self) -> Iterator[None]:
        try:
            yield
        except ImportError as e:
            self._deferred = (
                e,
                f"Tried to import '{e.name}' but failed. Please install the "
                f"optional dependency to use this feature. Original error: {e}",
            )

    def __enter__(self):
        self._cm = self._guard()
        self._cm.__enter__()
        return self

    def __exit__(self, *exc) -> bool | None:
        return self._cm.__exit__(*exc)

    def is_successful(self) -> bool:
        return self._deferred is None

    def check(self) -> None:
        if self._deferred is not None:
            exc, message = self._deferred
            raise ImportError(message) from exc


def try_import() -> _DeferredImportExceptionContextManager:
    return _DeferredImportExceptionContextManager()


class _LazyImport(types.ModuleType):
    """Module proxy that imports on first attribute access."""

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self._name = name

    def _load(self) -> types.ModuleType:
        module = importlib.import_module(self._name)
        self.__dict__.update(module.__dict__)
        return module

    def __getattr__(self, item: str) -> Any:
        return getattr(self._load(), item)
