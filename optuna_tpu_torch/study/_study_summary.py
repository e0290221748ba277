"""Study summary record (port of ``optuna_tpu/study/_study_summary.py``;
reference ``optuna/study/_study_summary.py:127``)."""

from __future__ import annotations

import datetime
from typing import Any

from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial


class StudySummary:
    def __init__(
        self,
        study_name: str,
        direction: StudyDirection | None,
        best_trial: FrozenTrial | None,
        user_attrs: dict[str, Any],
        system_attrs: dict[str, Any],
        n_trials: int,
        datetime_start: datetime.datetime | None,
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
        self.best_trial = best_trial
        self.user_attrs = user_attrs
        self.system_attrs = system_attrs
        self.n_trials = n_trials
        self.datetime_start = datetime_start
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
        if not isinstance(other, StudySummary):
            return NotImplemented
        return other.__dict__ == self.__dict__

    def __lt__(self, other: Any) -> bool:
        if not isinstance(other, StudySummary):
            return NotImplemented
        return self._study_id < other._study_id
