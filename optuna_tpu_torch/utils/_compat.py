"""API-lifecycle decorators (reference ``optuna/_experimental.py:51,91``,
``_deprecated.py``, ``_convert_positional_args.py:131``)."""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, TypeVar

from optuna_tpu_torch.exceptions import ExperimentalWarning

FT = TypeVar("FT", bound=Callable)
CT = TypeVar("CT", bound=type)


def experimental_func(version: str, name: str | None = None) -> Callable[[FT], FT]:
    def decorator(func: FT) -> FT:
        @functools.wraps(func)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            warnings.warn(
                f"{name or func.__name__} is experimental (supported from v{version}). "
                "The interface can change in the future.",
                ExperimentalWarning,
                stacklevel=2,
            )
            return func(*args, **kwargs)

        return wrapper  # type: ignore[return-value]

    return decorator


def experimental_class(version: str, name: str | None = None) -> Callable[[CT], CT]:
    def decorator(cls: CT) -> CT:
        original_init = cls.__init__

        @functools.wraps(original_init)
        def wrapped_init(self, *args: Any, **kwargs: Any) -> None:
            warnings.warn(
                f"{name or cls.__name__} is experimental (supported from v{version}). "
                "The interface can change in the future.",
                ExperimentalWarning,
                stacklevel=2,
            )
            original_init(self, *args, **kwargs)

        cls.__init__ = wrapped_init  # type: ignore[method-assign]
        return cls

    return decorator


def deprecated_func(
    deprecated_version: str, removed_version: str, text: str | None = None
) -> Callable[[FT], FT]:
    def decorator(func: FT) -> FT:
        @functools.wraps(func)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            warnings.warn(
                f"{func.__name__} has been deprecated in v{deprecated_version} and "
                f"will be removed in v{removed_version}. {text or ''}",
                FutureWarning,
                stacklevel=2,
            )
            return func(*args, **kwargs)

        return wrapper  # type: ignore[return-value]

    return decorator


def deprecated_class(
    deprecated_version: str, removed_version: str, text: str | None = None
) -> Callable[[CT], CT]:
    def decorator(cls: CT) -> CT:
        original_init = cls.__init__

        @functools.wraps(original_init)
        def wrapped_init(self, *args: Any, **kwargs: Any) -> None:
            warnings.warn(
                f"{cls.__name__} has been deprecated in v{deprecated_version} and "
                f"will be removed in v{removed_version}. {text or ''}",
                FutureWarning,
                stacklevel=2,
            )
            original_init(self, *args, **kwargs)

        cls.__init__ = wrapped_init  # type: ignore[method-assign]
        return cls

    return decorator


def convert_positional_args(
    *, previous_positional_arg_names: list[str], warning_stacklevel: int = 2
) -> Callable[[FT], FT]:
    """Accept legacy positional calls, warn, and forward as kwargs."""

    def decorator(func: FT) -> FT:
        @functools.wraps(func)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if len(args) > 0:
                warnings.warn(
                    f"{func.__name__}: positional arguments are deprecated; "
                    f"use keyword arguments ({previous_positional_arg_names[:len(args)]}).",
                    FutureWarning,
                    stacklevel=warning_stacklevel,
                )
                for name, value in zip(previous_positional_arg_names, args):
                    if name in kwargs:
                        raise TypeError(f"{func.__name__}() got multiple values for '{name}'")
                    kwargs[name] = value
            return func(**kwargs)

        return wrapper  # type: ignore[return-value]

    return decorator
