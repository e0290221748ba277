"""Frozen study record (reference ``optuna/study/_frozen.py:94``)."""

from __future__ import annotations

from typing import Any

from optuna_tpu_torch.study._study_direction import StudyDirection


class FrozenStudy:
    """Immutable snapshot of a study's metadata, as returned by
    ``storage.get_all_studies`` / ``get_all_study_summaries``."""

    def __init__(
        self,
        study_name: str,
        direction: StudyDirection | None,
        user_attrs: dict[str, Any],
        system_attrs: dict[str, Any],
        study_id: int,
        *,
        directions: list[StudyDirection] | None = None,
    ) -> None:
        self.study_name = study_name
        if direction is None and directions is None:
            raise ValueError("Specify one of `direction` and `directions`.")
        elif directions is not None:
            self._directions = list(directions)
        elif direction is not None:
            self._directions = [direction]
        else:
            raise ValueError("Specify only one of `direction` and `directions`.")
        self.user_attrs = user_attrs
        self.system_attrs = system_attrs
        self._study_id = study_id

    @property
    def direction(self) -> StudyDirection:
        if len(self._directions) > 1:
            raise RuntimeError(
                "This attribute is not available during multi-objective optimization."
            )
        return self._directions[0]

    @property
    def directions(self) -> list[StudyDirection]:
        return self._directions

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, FrozenStudy):
            return NotImplemented
        return other.__dict__ == self.__dict__

    def __lt__(self, other: Any) -> bool:
        if not isinstance(other, FrozenStudy):
            return NotImplemented
        return self._study_id < other._study_id

    def __repr__(self) -> str:
        return (
            f"FrozenStudy(study_name={self.study_name!r}, directions={self._directions}, "
            f"study_id={self._study_id})"
        )
