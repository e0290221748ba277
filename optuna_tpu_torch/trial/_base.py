"""Abstract trial interface (reference ``optuna/trial/_base.py:22``).

Library code should accept ``BaseTrial`` wherever a concrete trial flavour
(live :class:`Trial`, offline :class:`FixedTrial`, snapshot
:class:`FrozenTrial`) can appear — e.g. objective functions, which the
reference types as ``Callable[[BaseTrial], float]``."""

from __future__ import annotations

import abc
from typing import Any, Sequence


class BaseTrial(abc.ABC):
    """Common surface of Trial / FrozenTrial — the full member
    set library code may touch on any trial flavour (reference
    ``optuna/trial/_base.py``), so a user subclass satisfying this ABC is
    actually substitutable at runtime."""

    @abc.abstractmethod
    def suggest_float(
        self, name: str, low: float, high: float, *, step: float | None = None,
        log: bool = False,
    ) -> float:
        raise NotImplementedError

    @abc.abstractmethod
    def suggest_int(
        self, name: str, low: int, high: int, *, step: int = 1, log: bool = False
    ) -> int:
        raise NotImplementedError

    @abc.abstractmethod
    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        raise NotImplementedError

    @abc.abstractmethod
    def report(self, value: float, step: int) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def should_prune(self) -> bool:
        raise NotImplementedError

    @abc.abstractmethod
    def set_user_attr(self, key: str, value: Any) -> None:
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def params(self) -> dict[str, Any]:
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def distributions(self) -> dict[str, Any]:
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def user_attrs(self) -> dict[str, Any]:
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def number(self) -> int:
        raise NotImplementedError


def _register_concrete_trials() -> None:
    from optuna_tpu_torch.trial._fixed import FixedTrial
    from optuna_tpu_torch.trial._frozen import FrozenTrial
    from optuna_tpu_torch.trial._trial import Trial

    for cls in (Trial, FixedTrial, FrozenTrial):
        BaseTrial.register(cls)
