"""Study optimization direction (reference ``optuna/study/_study_direction.py:18``)."""

from __future__ import annotations

import enum


class StudyDirection(enum.IntEnum):
    """NOT_SET is only valid transiently while a study is being created."""

    NOT_SET = 0
    MINIMIZE = 1
    MAXIMIZE = 2

    def __repr__(self) -> str:
        return f"StudyDirection.{self.name}"
