"""optuna_tpu_torch — the PyTorch/CUDA port of ``optuna_tpu``.

The port runs beside the JAX package, which stays the reference. Six
paths are ported, on in-memory or durable storage (RDB over sqlite3, a
journal file or Redis; the retrying and caching wrappers, heartbeats and
retry callbacks) and the study runtime around them (``n_jobs`` threads,
the progress bar, study management, the Grid, BruteForce and PartialFixed
samplers, ``GuardedSampler``, ``FixedTrial``):

* **TPE**: ``TPESampler``, the default sampler of a single-objective
  study (univariate, multivariate and group, constant liar, constraints,
  MOTPE), with every pruner of the reference;
* **GP per trial**: ``create_study`` → ``Study.optimize`` → ``GPSampler``
  (exact engine, and the SGPR engine above ``n_exact_max``);
* **multi-objective**: ``NSGAIISampler`` (the default sampler of a
  multi-objective study), ``NSGAIIISampler`` and the hypervolume
  indicator (``hypervolume.compute_hypervolume``, leave-one-out
  contributions, the greedy subset selection ``solve_hssp``) at any number
  of objectives;
* **CMA-ES and QMC**: ``CmaEsSampler`` (its state on the card) and
  ``QMCSampler``;
* **scan**: ``Study.optimize_scan`` / ``parallel.optimize_scan``, the
  device-resident ask → evaluate → tell loop over a batched objective
  (``parallel.VectorizedObjective``), exact and SGPR chunks, resumable
  after a kill from the checkpoint ring (``resume=True``);
* **batched trials**: ``Study.ask_batch`` and ``parallel.optimize_vectorized``
  (``ResilientBatchExecutor``: quarantine, bisection, OOM halving, the
  dispatch deadline), B trials a dispatch of a batched objective, such as
  config #5's MLP (``models.mlp``).

Analysis and early stopping sit on those paths: ``importance`` (fANOVA and
mean decrease impurity over a histogram random forest grown on the card,
PED-ANOVA on the host), ``terminator`` (the GP regret bound and EMMR on the
card, stagnation, the error evaluators, ``TerminatorCallback``),
``visualization`` (plotly-schema figures and a matplotlib mirror),
``artifacts``, ``cli`` and ``integration``.

Observability and control run on the host beside every path: ``telemetry``
(metrics and their Prometheus and JSON exports, ``serve_metrics``),
``flight`` (the per-trial timeline, Chrome-trace export, postmortems),
``health`` (the study doctor over the workers' snapshots in storage),
``slo`` (latency objectives and burn rates), ``autopilot`` (the doctor's
findings answered by guarded, reversible actions, ``gp.densify`` among
them) and ``_tracing`` (``torch.profiler`` traces of a run); each is off
until enabled, in code or by an ``OPTUNA_TPU_TORCH_*`` switch.

Every TPU kernel these paths reach is a hand-written CUDA kernel for Hopper
(``ops/kernels/csrc``): the Matérn-5/2 cross-covariance, the
non-domination ranking (NSGA-II, and MOTPE's split), the WFG hypervolume
stack (also the HSSP's scorer at five objectives or more); TPE's plane,
the hypervolume slicing engine and CMA-ES are plain torch ops. Numerical entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no GPU they raise instead
of moving to the CPU.
"""

from optuna_tpu_torch import _device  # noqa: F401  (TF32 off before any tensor work)
from optuna_tpu_torch.utils._compile_cache import ensure_compile_cache as _ensure_compile_cache

# The kernels' build directory: OPTUNA_TPU_TORCH_CACHE_DIR, or a fresh
# temporary one under OPTUNA_TPU_TORCH_NO_COMPILE_CACHE=1 (no-op otherwise).
_ensure_compile_cache()

from optuna_tpu_torch import distributions, exceptions, importance, logging, pruners, samplers
from optuna_tpu_torch import search_space, storages, study, trial, utils
from optuna_tpu_torch import parallel  # after study and trial: the scan loop builds trials
from optuna_tpu_torch.exceptions import TrialPruned
from optuna_tpu_torch.study import (
    Study,
    StudyDirection,
    StudySummary,
    copy_study,
    create_study,
    delete_study,
    get_all_study_names,
    get_all_study_summaries,
    load_study,
)
from optuna_tpu_torch.trial import FixedTrial, FrozenTrial, Trial, TrialState, create_trial
from optuna_tpu_torch.version import __version__

__all__ = [
    "FixedTrial",
    "FrozenTrial",
    "Study",
    "StudyDirection",
    "StudySummary",
    "Trial",
    "TrialPruned",
    "TrialState",
    "__version__",
    "artifacts",
    "cli",
    "copy_study",
    "create_study",
    "create_trial",
    "delete_study",
    "distributions",
    "exceptions",
    "get_all_study_names",
    "get_all_study_summaries",
    "importance",
    "integration",
    "load_study",
    "logging",
    "parallel",
    "pruners",
    "samplers",
    "search_space",
    "storages",
    "study",
    "terminator",
    "trial",
    "utils",
    "visualization",
]


# Heavy or optional subpackages load lazily, as the reference's do
# (``optuna_tpu/__init__.py``).
_LAZY_SUBPACKAGES = frozenset(
    {"artifacts", "cli", "integration", "progress_bar", "terminator", "visualization"}
)


def __getattr__(name: str):
    if name in _LAZY_SUBPACKAGES:
        import importlib

        return importlib.import_module(f"optuna_tpu_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return sorted(set(globals()) | _LAZY_SUBPACKAGES)
