"""Trials -> pandas DataFrame export (port of ``optuna_tpu/study/_dataframe.py``;
reference ``optuna/study/_dataframe.py``). ``pandas`` is optional and
imported at the call."""

from __future__ import annotations

import collections
from typing import TYPE_CHECKING, Any

from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    import pandas as pd

    from optuna_tpu_torch.study.study import Study


def _create_records_and_aggregate_column(
    study: "Study", attrs: tuple[str, ...]
) -> tuple[list[dict[tuple[str, str], Any]], dict[tuple[str, str], None]]:
    attrs_to_df_columns: dict[str, str] = {a: a.lstrip("_") for a in attrs}
    metric_names = study.metric_names

    records = []
    columns: dict[tuple[str, str], None] = collections.OrderedDict()
    for trial in study.get_trials(deepcopy=False):
        record: dict[tuple[str, str], Any] = {}
        for attr, df_column in attrs_to_df_columns.items():
            value = getattr(trial, attr, None)
            if attr == "value":
                value = trial.values[0] if trial.values is not None else None
            if isinstance(value, TrialState):
                value = value.name
            if isinstance(value, dict):
                for nested_attr, nested_value in value.items():
                    record[(df_column, nested_attr)] = nested_value
                    columns[(df_column, nested_attr)] = None
            elif attr == "values":
                trial_values = trial.values if trial.values is not None else []
                for i, v in enumerate(trial_values):
                    key = metric_names[i] if metric_names is not None else str(i)
                    record[(df_column, key)] = v
                    columns[(df_column, key)] = None
            else:
                record[(df_column, "")] = value
                columns[(df_column, "")] = None
        records.append(record)
    return records, columns


def _trials_dataframe(
    study: "Study", attrs: tuple[str, ...], multi_index: bool
) -> "pd.DataFrame":
    import pandas as pd

    if study._is_multi_objective() and "value" in attrs:
        attrs = tuple("values" if a == "value" else a for a in attrs)

    records, columns = _create_records_and_aggregate_column(study, attrs)
    df = pd.DataFrame(records, columns=pd.MultiIndex.from_tuples(list(columns.keys())))
    if not multi_index:
        df.columns = ["_".join(filter(len, map(str, col))) for col in columns.keys()]
    return df
