"""Study package (reference ``optuna_tpu/study/__init__.py``)."""

from optuna_tpu_torch._callbacks import MaxTrialsCallback
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.study._study_summary import StudySummary
from optuna_tpu_torch.study.study import (
    ObjectiveFuncType,
    Study,
    copy_study,
    create_study,
    delete_study,
    get_all_study_names,
    get_all_study_summaries,
    load_study,
)

__all__ = [
    "MaxTrialsCallback",
    "ObjectiveFuncType",
    "Study",
    "StudyDirection",
    "StudySummary",
    "copy_study",
    "create_study",
    "delete_study",
    "get_all_study_names",
    "get_all_study_summaries",
    "load_study",
]
