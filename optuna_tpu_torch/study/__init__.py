"""Study package (reference ``optuna_tpu/study/__init__.py``)."""

from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.study.study import ObjectiveFuncType, Study, create_study

__all__ = ["ObjectiveFuncType", "Study", "StudyDirection", "create_study"]
