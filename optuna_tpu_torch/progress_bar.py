"""tqdm progress bar with best-value postfix (port of
``optuna_tpu/progress_bar.py``; reference ``optuna/progress_bar.py:32``).

``tqdm`` is optional: it is imported only when a bar is asked for, and
without it the bar is disabled with a warning, as in the reference."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from optuna_tpu_torch import logging as logging_module

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = logging_module.get_logger(__name__)


def _import_tqdm() -> Any:
    """``tqdm.auto.tqdm``, or None when tqdm is not installed."""
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return None
    return tqdm


class _ProgressBar:
    def __init__(
        self,
        is_valid: bool,
        n_trials: int | None = None,
        timeout: float | None = None,
    ) -> None:
        tqdm = _import_tqdm() if is_valid else None
        if is_valid and tqdm is None:
            _logger.warning("tqdm is not installed; progress bar is disabled.")
            is_valid = False
        self._is_valid = is_valid and (n_trials or timeout) is not None
        self._n_trials = n_trials
        self._timeout = timeout
        self._last_elapsed_seconds = 0.0
        if self._is_valid:
            if self._n_trials is not None:
                self._progress_bar = tqdm(total=self._n_trials)
            elif self._timeout is not None:
                total = tqdm.format_interval(self._timeout)
                fmt = "{desc} {percentage:3.0f}%|{bar}| {elapsed}/" + total
                self._progress_bar = tqdm(total=self._timeout, bar_format=fmt)
            else:
                raise AssertionError

    def update(self, elapsed_seconds: float, study: "Study") -> None:
        if not self._is_valid:
            return
        if not study._is_multi_objective():
            try:
                msg = (
                    f"Best trial: {study.best_trial.number}. "
                    f"Best value: {study.best_value:.6g}"
                )
            except ValueError:
                msg = "Best trial: None. Best value: None"
            self._progress_bar.set_description(msg)
        if self._n_trials is not None:
            self._progress_bar.update(1)
            if self._timeout is not None:
                self._progress_bar.set_postfix_str(
                    f"{elapsed_seconds:.02f}/{self._timeout} seconds"
                )
        elif self._timeout is not None:
            time_diff = elapsed_seconds - self._last_elapsed_seconds
            if elapsed_seconds > self._timeout:
                time_diff -= elapsed_seconds - self._timeout
            self._progress_bar.update(time_diff)
            self._last_elapsed_seconds = elapsed_seconds

    def close(self) -> None:
        if self._is_valid:
            self._progress_bar.close()
