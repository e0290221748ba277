"""Search-space distributions.

Parity target: ``optuna/distributions.py`` (``FloatDistribution:109``,
``IntDistribution:310``, ``CategoricalDistribution:470``, JSON (de)serialization,
``check_distribution_compatibility``). Three canonical distributions; the
internal representation of every parameter is a plain ``float`` (categoricals
store the choice *index*), which is what lets the numeric plane stay a dense
``float`` array that JAX can jit over.
"""

from __future__ import annotations

import decimal
import json
import math
from typing import Any, Sequence, Union


CategoricalChoiceType = Union[None, bool, int, float, str]

_float_distribution_key = "FloatDistribution"
_int_distribution_key = "IntDistribution"
_categorical_distribution_key = "CategoricalDistribution"


class BaseDistribution:
    """Base class for parameter distributions.

    External representation = what the user's objective receives from
    ``trial.suggest_*``. Internal representation = the float stored in the
    storage layer and consumed by samplers.
    """

    def to_external_repr(self, param_value_in_internal_repr: float) -> Any:
        return param_value_in_internal_repr

    def to_internal_repr(self, param_value_in_external_repr: Any) -> float:
        return float(param_value_in_external_repr)

    def single(self) -> bool:
        """Whether the domain contains exactly one value."""
        raise NotImplementedError

    def _contains(self, param_value_in_internal_repr: float) -> bool:
        raise NotImplementedError

    def _asdict(self) -> dict:
        return self.__dict__

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, BaseDistribution):
            return NotImplemented
        if type(self) is not type(other):
            return False
        return self.__dict__ == other.__dict__

    def __hash__(self) -> int:
        return hash((type(self),) + tuple(sorted(self.__dict__.items(), key=lambda x: x[0])))

    def __repr__(self) -> str:
        kwargs = ", ".join(f"{k}={v!r}" for k, v in sorted(self._asdict().items()))
        return f"{type(self).__name__}({kwargs})"


class FloatDistribution(BaseDistribution):
    """Continuous domain ``[low, high]``, optionally log-scaled or discretized by ``step``.

    Mirrors the validation rules of ``optuna/distributions.py:109-180``:
    ``log`` and ``step`` are mutually exclusive; ``log`` requires ``low > 0``;
    with ``step``, ``high`` is snapped down onto the grid.
    """

    def __init__(
        self, low: float, high: float, log: bool = False, step: float | None = None
    ) -> None:
        if log and step is not None:
            raise ValueError("The parameter `step` is not supported when `log` is True.")
        if low > high:
            raise ValueError(f"`low <= high` must hold, but got low={low}, high={high}.")
        if log and low <= 0.0:
            raise ValueError(f"`low > 0` must hold for log domains, but got low={low}.")
        if step is not None and step <= 0:
            raise ValueError(f"`step > 0` must hold, but got step={step}.")
        self.low = float(low)
        self.high = float(high)
        self.log = log
        self.step = None if step is None else float(step)
        if step is not None:
            self.high = _adjust_discrete_uniform_high(self.low, self.high, self.step)

    def single(self) -> bool:
        if self.step is None:
            return self.low == self.high
        return self.high - self.low < self.step

    def _contains(self, param_value_in_internal_repr: float) -> bool:
        return self.low <= param_value_in_internal_repr <= self.high

    def to_internal_repr(self, param_value_in_external_repr: Any) -> float:
        try:
            internal = float(param_value_in_external_repr)
        except (ValueError, TypeError) as e:
            raise ValueError(f"'{param_value_in_external_repr}' is not a valid float.") from e
        if math.isnan(internal):
            raise ValueError(f"`{internal}` is invalid for FloatDistribution.")
        return internal


class IntDistribution(BaseDistribution):
    """Integer domain ``[low, high]`` with ``step`` granularity or log scale.

    Mirrors ``optuna/distributions.py:310-400``: ``log`` forces ``step == 1``;
    ``high`` snaps down onto the step grid.
    """

    def __init__(self, low: int, high: int, log: bool = False, step: int = 1) -> None:
        if log and step != 1:
            raise ValueError("The parameter `step != 1` is not supported when `log` is True.")
        if low > high:
            raise ValueError(f"`low <= high` must hold, but got low={low}, high={high}.")
        if log and low < 1:
            raise ValueError(f"`low >= 1` must hold for log domains, but got low={low}.")
        if step <= 0:
            raise ValueError(f"`step > 0` must hold, but got step={step}.")
        self.log = log
        self.low = int(low)
        self.high = int(high)
        self.step = int(step)
        self.high = self.high - (self.high - self.low) % self.step

    def to_external_repr(self, param_value_in_internal_repr: float) -> int:
        return int(param_value_in_internal_repr)

    def to_internal_repr(self, param_value_in_external_repr: Any) -> float:
        try:
            internal = float(param_value_in_external_repr)
        except (ValueError, TypeError) as e:
            raise ValueError(f"'{param_value_in_external_repr}' is not a valid int.") from e
        if math.isnan(internal):
            raise ValueError(f"`{internal}` is invalid for IntDistribution.")
        return internal

    def single(self) -> bool:
        return self.low == self.high or self.high - self.low < self.step

    def _contains(self, param_value_in_internal_repr: float) -> bool:
        value = param_value_in_internal_repr
        return self.low <= value <= self.high


class CategoricalDistribution(BaseDistribution):
    """Unordered finite choice set; internal repr is the choice index.

    Mirrors ``optuna/distributions.py:470-560``. Choices may be ``None``,
    ``bool``, ``int``, ``float`` or ``str``; other types warn but are allowed
    (they must then be pickle-able and comparable by ``==``).
    """

    def __init__(self, choices: Sequence[CategoricalChoiceType]) -> None:
        if len(choices) == 0:
            raise ValueError("The `choices` must contain one or more elements.")
        self.choices = tuple(choices)

    def to_external_repr(self, param_value_in_internal_repr: float) -> CategoricalChoiceType:
        return self.choices[int(param_value_in_internal_repr)]

    def to_internal_repr(self, param_value_in_external_repr: Any) -> float:
        try:
            return float(self.choices.index(param_value_in_external_repr))
        except ValueError as e:
            raise ValueError(
                f"'{param_value_in_external_repr}' not in {self.choices}."
            ) from e

    def single(self) -> bool:
        return len(self.choices) == 1

    def _contains(self, param_value_in_internal_repr: float) -> bool:
        index = int(param_value_in_internal_repr)
        return 0 <= index < len(self.choices)

    def __hash__(self) -> int:
        # Choices may contain unhashable user objects; fall back to repr.
        try:
            return hash((type(self), self.choices))
        except TypeError:
            return hash((type(self), repr(self.choices)))


DistributionType = Union[FloatDistribution, IntDistribution, CategoricalDistribution]

_CLASSES: dict[str, type] = {
    _float_distribution_key: FloatDistribution,
    _int_distribution_key: IntDistribution,
    _categorical_distribution_key: CategoricalDistribution,
}


def _adjust_discrete_uniform_high(low: float, high: float, step: float) -> float:
    # Decimal arithmetic avoids float-representation drift when snapping
    # ``high`` down onto the (low + k*step) grid (reference distributions.py:700).
    d_high = decimal.Decimal(str(high))
    d_low = decimal.Decimal(str(low))
    d_step = decimal.Decimal(str(step))
    d_r = d_high - d_low
    if d_r % d_step != decimal.Decimal("0"):
        high = float((d_r // d_step) * d_step + d_low)
    return high


def distribution_to_json(dist: BaseDistribution) -> str:
    """Serialize a distribution for the storage layer (reference distributions.py:583).

    The *exact* class name is written — legacy alias classes round-trip as
    themselves, so ``==`` and compatibility checks hold across storage."""
    name = type(dist).__name__
    if name in _LEGACY_ENCODERS:
        return json.dumps({"name": name, "attributes": _LEGACY_ENCODERS[name](dist)})
    for cname, cls in _CLASSES.items():
        if isinstance(dist, cls):
            return json.dumps({"name": cname, "attributes": dist._asdict()})
    raise ValueError(f"Unknown distribution class: {type(dist)}")


def json_to_distribution(json_str: str) -> BaseDistribution:
    """Deserialize a distribution (reference distributions.py:605), including
    studies written under the reference's pre-v3 legacy class names."""
    loaded = json.loads(json_str)
    name = loaded["name"]
    attributes = loaded["attributes"]
    if name == _categorical_distribution_key:
        return CategoricalDistribution(choices=tuple(attributes["choices"]))
    legacy = _LEGACY_DECODERS.get(name)
    if legacy is not None:
        return legacy(attributes)
    cls = _CLASSES.get(name)
    if cls is None:
        raise ValueError(f"Unknown distribution name: {name}")
    return cls(**attributes)


def check_distribution_compatibility(
    dist_old: BaseDistribution, dist_new: BaseDistribution
) -> None:
    """Raise if two distributions for the same parameter name are incompatible.

    Same-class is required; categorical choices must match exactly; numeric
    bounds may drift (define-by-run spaces can shrink/grow between trials) —
    reference ``optuna/distributions.py:631-660``.
    """
    if dist_old.__class__ != dist_new.__class__:
        raise ValueError(
            f"Cannot set different distribution kind to the same parameter name: "
            f"{dist_old} != {dist_new}."
        )
    if isinstance(dist_old, CategoricalDistribution):
        assert isinstance(dist_new, CategoricalDistribution)
        if dist_old.choices != dist_new.choices:
            raise ValueError(
                CategoricalDistribution.__name__
                + " does not support dynamic value space: "
                f"{dist_old.choices} != {dist_new.choices}."
            )


# ------------------------------------------------------- deprecated aliases
# Drop-in names from the reference's pre-v3 API (``optuna/distributions.py:
# 196-330``): thin constructors over the three canonical distributions, kept
# so studies/configs written against the old names keep working.


class UniformDistribution(FloatDistribution):
    """Deprecated: use ``FloatDistribution(low, high)``."""

    def __init__(self, low: float, high: float) -> None:
        super().__init__(low=low, high=high, log=False, step=None)


class LogUniformDistribution(FloatDistribution):
    """Deprecated: use ``FloatDistribution(low, high, log=True)``."""

    def __init__(self, low: float, high: float) -> None:
        super().__init__(low=low, high=high, log=True, step=None)


class DiscreteUniformDistribution(FloatDistribution):
    """Deprecated: use ``FloatDistribution(low, high, step=q)``."""

    def __init__(self, low: float, high: float, q: float) -> None:
        super().__init__(low=low, high=high, log=False, step=q)

    @property
    def q(self) -> float:
        assert self.step is not None
        return self.step


class IntUniformDistribution(IntDistribution):
    """Deprecated: use ``IntDistribution(low, high, step=step)``."""

    def __init__(self, low: int, high: int, step: int = 1) -> None:
        super().__init__(low=low, high=high, log=False, step=step)


class IntLogUniformDistribution(IntDistribution):
    """Deprecated: use ``IntDistribution(low, high, log=True)``."""

    def __init__(self, low: int, high: int, step: int = 1) -> None:
        super().__init__(low=low, high=high, log=True, step=step)


DISTRIBUTION_CLASSES = (
    IntDistribution,
    IntLogUniformDistribution,
    IntUniformDistribution,
    FloatDistribution,
    DiscreteUniformDistribution,
    LogUniformDistribution,
    UniformDistribution,
    CategoricalDistribution,
)

# JSON round-trip for the legacy names, mirroring each alias' constructor
# signature so stored studies written under either API load as the exact
# class they were saved with.
_LEGACY_ENCODERS = {
    "UniformDistribution": lambda d: {"low": d.low, "high": d.high},
    "LogUniformDistribution": lambda d: {"low": d.low, "high": d.high},
    "DiscreteUniformDistribution": lambda d: {"low": d.low, "high": d.high, "q": d.step},
    "IntUniformDistribution": lambda d: {"low": d.low, "high": d.high, "step": d.step},
    "IntLogUniformDistribution": lambda d: {"low": d.low, "high": d.high, "step": d.step},
}
_LEGACY_DECODERS = {
    "UniformDistribution": lambda a: UniformDistribution(a["low"], a["high"]),
    "LogUniformDistribution": lambda a: LogUniformDistribution(a["low"], a["high"]),
    "DiscreteUniformDistribution": lambda a: DiscreteUniformDistribution(
        a["low"], a["high"], a["q"]
    ),
    "IntUniformDistribution": lambda a: IntUniformDistribution(
        a["low"], a["high"], a.get("step", 1)
    ),
    "IntLogUniformDistribution": lambda a: IntLogUniformDistribution(
        a["low"], a["high"], a.get("step", 1)
    ),
}
