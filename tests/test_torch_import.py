"""Import hygiene and device policy of the PyTorch port.

The port must never pull in JAX or the reference package: importing
``optuna_tpu`` alone starts JAX and its compile cache. A subprocess shows
the runtime side, an AST scan shows no module of the port (nor
``chip_smoke.py``) names either.
"""

from __future__ import annotations

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "optuna_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optuna_tpu")


def _all_modules() -> list[str]:
    import optuna_tpu_torch

    return ["optuna_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(optuna_tpu_torch.__path__, "optuna_tpu_torch.")
    ]


def test_importing_every_module_loads_neither_jax_nor_the_reference():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_all_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'optuna_tpu'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO, timeout=120
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["n"] > 30
    assert result["bad"] == []


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_module_of_the_port_imports_jax_or_the_reference(path):
    assert not (_imported_roots(path) & set(FORBIDDEN))


def test_tf32_is_off_after_import():
    import optuna_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_is_cuda_and_never_slips_to_the_cpu():
    from optuna_tpu_torch._device import resolve_device
    from optuna_tpu_torch.samplers import GPSampler

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert GPSampler()._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no GPU"):
            GPSampler()
    assert GPSampler(device="cpu")._device.type == "cpu"


def test_create_study_without_a_sampler_names_the_roadmap_item():
    # ROADMAP item A4 (TPE) is ported: the single-objective default is
    # TPESampler, whose device (the card) is resolved at its first ask.
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import TPESampler

    assert isinstance(ot.create_study().sampler, TPESampler)


MULTI_OBJECTIVE_MODULES = [
    "optuna_tpu_torch.hypervolume",
    "optuna_tpu_torch.hypervolume.hssp",
    "optuna_tpu_torch.hypervolume.wfg",
    "optuna_tpu_torch.ops.hypervolume",
    "optuna_tpu_torch.ops.kernels.nds",
    "optuna_tpu_torch.ops.kernels.wfg",
    "optuna_tpu_torch.ops.pareto",
    "optuna_tpu_torch.ops.wfg",
    "optuna_tpu_torch.samplers._ga._base",
    "optuna_tpu_torch.samplers.nsgaii._crossovers",
    "optuna_tpu_torch.samplers.nsgaii._elite",
    "optuna_tpu_torch.samplers.nsgaii._mutations",
    "optuna_tpu_torch.samplers.nsgaii._sampler",
]


def test_the_multi_objective_modules_are_among_those_checked():
    assert set(MULTI_OBJECTIVE_MODULES) <= set(_all_modules())


SCAN_MODULES = [
    "optuna_tpu_torch.checkpoint",
    "optuna_tpu_torch.device_stats",
    "optuna_tpu_torch.parallel",
    "optuna_tpu_torch.parallel.scan_loop",
    "optuna_tpu_torch.parallel.vectorized",
    "optuna_tpu_torch.telemetry",
]


def test_the_scan_modules_are_among_those_checked():
    assert set(SCAN_MODULES) <= set(_all_modules())


GP_MODULES = [
    "optuna_tpu_torch.gp.acqf",
    "optuna_tpu_torch.gp.box_decomposition",
    "optuna_tpu_torch.gp.convert",
    "optuna_tpu_torch.gp.fused",
    "optuna_tpu_torch.gp.gp",
    "optuna_tpu_torch.gp.optim_mixed",
    "optuna_tpu_torch.gp.sparse",
    "optuna_tpu_torch.ops.special",
    "optuna_tpu_torch.samplers._gp.sampler",
]


def test_the_gp_modules_are_among_those_checked():
    assert set(GP_MODULES) <= set(_all_modules())


@pytest.mark.parametrize("module", ["matern", "nds", "wfg", "mlp_head"])
def test_every_kernel_wrapper_counts_launches_and_names_its_source(module):
    import importlib

    from optuna_tpu_torch.ops.kernels import _nvcc

    mod = importlib.import_module(f"optuna_tpu_torch.ops.kernels.{module}")
    assert isinstance(mod.LAUNCHES, int)
    assert (_nvcc.CSRC / mod._SOURCE).is_file()


def test_multi_objective_device_policy():
    import numpy as np

    from optuna_tpu_torch.ops.pareto import non_domination_rank_np
    from optuna_tpu_torch.ops.wfg import hypervolume_wfg_nd
    from optuna_tpu_torch.samplers import NSGAIISampler

    assert NSGAIISampler()._device is None  # resolved where a large pool is ranked
    assert NSGAIISampler(device="cpu")._device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            non_domination_rank_np(np.zeros((4, 2)))
        with pytest.raises(RuntimeError, match="no GPU"):
            hypervolume_wfg_nd(np.zeros((4, 5)), np.ones(5))


RUNTIME_MODULES = [
    "optuna_tpu_torch._callbacks",
    "optuna_tpu_torch.parallel.executor",
    "optuna_tpu_torch.progress_bar",
    "optuna_tpu_torch.samplers._brute_force",
    "optuna_tpu_torch.samplers._grid",
    "optuna_tpu_torch.samplers._partial_fixed",
    "optuna_tpu_torch.samplers._resilience",
    "optuna_tpu_torch.storages._cached_storage",
    "optuna_tpu_torch.storages._callbacks",
    "optuna_tpu_torch.storages._heartbeat",
    "optuna_tpu_torch.storages._retry",
    "optuna_tpu_torch.study._dataframe",
    "optuna_tpu_torch.study._study_summary",
    "optuna_tpu_torch.testing",
    "optuna_tpu_torch.testing.fault_injection",
    "optuna_tpu_torch.testing.pytest_samplers",
    "optuna_tpu_torch.testing.pytest_storages",
    "optuna_tpu_torch.utils",
    "optuna_tpu_torch.utils._compat",
    "optuna_tpu_torch.utils._imports",
]


def test_the_runtime_modules_import_with_jax_and_the_reference_blocked():
    """A finder that refuses ``jax``, ``jaxlib`` and ``optuna_tpu`` sits
    first on ``sys.meta_path``: every runtime module still imports, and
    pandas stays unimported (it is optional and imported at use; tqdm is
    too, but torch itself may import it)."""
    assert set(RUNTIME_MODULES) <= set(_all_modules())
    code = (
        "import importlib, importlib.abc, json, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {RUNTIME_MODULES!r}: importlib.import_module(m)\n"
        "import optuna_tpu_torch as ot\n"
        "names = ['GridSampler', 'BruteForceSampler', 'PartialFixedSampler', 'GuardedSampler']\n"
        "assert all(getattr(ot.samplers, n) for n in names)\n"
        "assert all(callable(getattr(ot, n)) for n in ('load_study', 'delete_study', 'copy_study',\n"
        "                                              'get_all_study_names', 'get_all_study_summaries'))\n"
        "assert all(getattr(ot.storages, n) for n in ('RetryingStorage', 'RetryPolicy', 'TransientStorageError',\n"
        "    'RetryFailedTrialCallback', 'RetryHeartbeatStaleTrialCallback', 'fail_stale_trials'))\n"
        "assert ot.study.MaxTrialsCallback and ot.Study.trials_dataframe\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] == 'pandas')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _module_level_roots(path: Path) -> set[str]:
    """Roots imported at a module's top level, ``if TYPE_CHECKING:`` blocks
    left out."""
    roots = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.If) and "TYPE_CHECKING" in ast.unparse(node.test):
            continue
        for sub in ast.walk(node) if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) else ():
            if isinstance(sub, ast.Import):
                roots.update(alias.name.split(".")[0] for alias in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0 and sub.module:
                roots.add(sub.module.split(".")[0])
    return roots


SLICE_MODULES = [
    "optuna_tpu_torch.ops.cmaes",
    "optuna_tpu_torch.ops.hypervolume",
    "optuna_tpu_torch.ops.qmc",
    "optuna_tpu_torch.samplers._cmaes",
    "optuna_tpu_torch.samplers._nsgaiii",
    "optuna_tpu_torch.samplers._nsgaiii._sampler",
    "optuna_tpu_torch.samplers._qmc",
]


def test_the_cmaes_qmc_and_nsga3_modules_import_with_jax_and_the_reference_blocked():
    assert set(SLICE_MODULES) <= set(_all_modules())
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "import optuna_tpu_torch as ot\n"
        "for n in ('CmaEsSampler', 'QMCSampler', 'NSGAIIISampler', 'BaseGASampler'): getattr(ot.samplers, n)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO, timeout=120
    )
    assert out.returncode == 0, out.stderr


def test_every_name_in_the_samplers_all_resolves():
    from optuna_tpu_torch import samplers

    for name in samplers.__all__:
        assert getattr(samplers, name) is not None, name
    assert {"BaseGASampler", "CmaEsSampler", "NSGAIIISampler", "QMCSampler"} <= set(samplers.__all__)
    with pytest.raises(AttributeError):
        samplers.NoSuchSampler  # noqa: B018


def test_pandas_and_tqdm_are_imported_only_where_used():
    """The card host has neither: no module of the port imports them at its
    top level, and ``chip_smoke.py`` never."""
    for path in sorted(PACKAGE.rglob("*.py")):
        assert not (_module_level_roots(path) & {"pandas", "tqdm"}), path
    assert not (_imported_roots(REPO / "chip_smoke.py") & {"pandas", "tqdm"})


BATCH_MODULES = [
    "optuna_tpu_torch.models",
    "optuna_tpu_torch.models.mlp",
    "optuna_tpu_torch.parallel.executor",
    "optuna_tpu_torch.parallel.vectorized",
    "optuna_tpu_torch.study.study",
    "optuna_tpu_torch.testing.fault_injection",
]


def test_the_batch_modules_import_with_jax_and_the_reference_blocked():
    """Batched trial execution (``optimize_vectorized``, the executor and its
    fault kit, ``ask_batch``, config #5's MLP) imports with ``jax``,
    ``jaxlib`` and ``optuna_tpu`` refused."""
    assert set(BATCH_MODULES) <= set(_all_modules())
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {BATCH_MODULES!r}: importlib.import_module(m)\n"
        "import optuna_tpu_torch as ot\n"
        "from optuna_tpu_torch.testing import fault_injection as kit\n"
        "for n in ('optimize_vectorized', 'ResilientBatchExecutor', 'NON_FINITE_POLICIES',\n"
        "          'NonFiniteObjectiveError', 'DispatchTimeoutError'):\n"
        "    assert n in ot.parallel.__all__ and getattr(ot.parallel, n)\n"
        "for n in ('FaultyVectorizedObjective', 'FakeResourceExhaustedError', 'NON_FINITE_CHAOS_POLICIES',\n"
        "          'FALLBACK_CHAOS_POLICIES'): getattr(kit, n)\n"
        "assert ot.Study.ask_batch and ot.models.mlp.train_scaled_batch and ot.models.branin\n"
        "assert 'mlp' in ot.models.__all__\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO, timeout=120
    )
    assert out.returncode == 0, out.stderr


A10_MODULES = [
    "optuna_tpu_torch.artifacts",
    "optuna_tpu_torch.artifacts._backends",
    "optuna_tpu_torch.artifacts.exceptions",
    "optuna_tpu_torch.cli",
    "optuna_tpu_torch.importance",
    "optuna_tpu_torch.importance._base",
    "optuna_tpu_torch.importance._evaluate",
    "optuna_tpu_torch.importance._fanova",
    "optuna_tpu_torch.importance._mean_decrease_impurity",
    "optuna_tpu_torch.importance._ped_anova",
    "optuna_tpu_torch.integration",
    "optuna_tpu_torch.ops.forest",
    "optuna_tpu_torch.terminator",
    "optuna_tpu_torch.terminator._evaluators",
    "optuna_tpu_torch.terminator._terminator",
    "optuna_tpu_torch.terminator.callback",
    "optuna_tpu_torch.terminator.erroreval",
    "optuna_tpu_torch.terminator.improvement",
    "optuna_tpu_torch.terminator.improvement.emmr",
    "optuna_tpu_torch.terminator.improvement.evaluator",
    "optuna_tpu_torch.terminator.median_erroreval",
    "optuna_tpu_torch.terminator.terminator",
    "optuna_tpu_torch.visualization",
    "optuna_tpu_torch.visualization._data",
    "optuna_tpu_torch.visualization.matplotlib",
    "optuna_tpu_torch.visualization.matplotlib._plots",
]
#: What the card host lacks (``PERF.md``): the A10 modules import, and a
#: figure dict is built, with these refused too.
CARD_HOST_MISSING = ("matplotlib", "sklearn", "pandas", "plotly")


def test_the_analysis_modules_import_with_jax_the_reference_and_plotting_blocked():
    """Analysis and early stopping (A10) import with ``jax``, ``jaxlib``,
    ``optuna_tpu`` and the plotting and table packages refused; the
    importance evaluators, the terminator and a plotly-schema figure run
    (on the CPU), and the CLI parses."""
    assert set(A10_MODULES) <= set(_all_modules())
    blocked = FORBIDDEN + CARD_HOST_MISSING
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        f"        if name.split('.')[0] in {blocked!r}:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {A10_MODULES!r}: importlib.import_module(m)\n"
        "import optuna_tpu_torch as ot\n"
        "from optuna_tpu_torch.samplers import RandomSampler\n"
        "s = ot.create_study(sampler=RandomSampler(seed=0))\n"
        "s.optimize(lambda t: t.suggest_float('a', 0, 1) ** 2 + 0.1 * t.suggest_float('b', 0, 1), n_trials=25)\n"
        "imp = ot.importance.get_param_importances(s, evaluator=ot.importance.FanovaImportanceEvaluator(\n"
        "    n_trees=4, seed=0, device='cpu'))\n"
        "assert set(imp) == {'a', 'b'}\n"
        "assert ot.terminator.RegretBoundEvaluator(device='cpu').evaluate(s.trials, s.direction) > 0\n"
        "fig = ot.visualization.plot_optimization_history(s)\n"
        "assert isinstance(fig, dict) and fig['data']\n"
        "assert not ot.visualization.matplotlib.is_available()\n"
        "assert ot.cli._build_parser().parse_args(['studies', '--storage', 'x']).command == 'studies'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO, timeout=120
    )
    assert out.returncode == 0, out.stderr


def test_plotting_and_table_packages_are_imported_only_where_used():
    """The card host has no matplotlib, scikit-learn, pandas or plotly: no
    module of the port imports them at its top level."""
    for path in sorted(PACKAGE.rglob("*.py")):
        assert not (_module_level_roots(path) & set(CARD_HOST_MISSING)), path


OBSERVABILITY_MODULES = [
    "optuna_tpu_torch._device_policy",
    "optuna_tpu_torch._tracing",
    "optuna_tpu_torch.autopilot",
    "optuna_tpu_torch.device_stats",
    "optuna_tpu_torch.flight",
    "optuna_tpu_torch.health",
    "optuna_tpu_torch.locksan",
    "optuna_tpu_torch.slo",
    "optuna_tpu_torch.storages._grpc",
    "optuna_tpu_torch.storages._grpc.fleet",
    "optuna_tpu_torch.telemetry",
    "optuna_tpu_torch.utils._compile_cache",
]


def test_the_observability_modules_import_with_jax_and_the_reference_blocked():
    """The observability and control modules, which the reference keeps to
    the standard library, import with ``jax`` and ``optuna_tpu`` refused,
    and the doctor, the autopilot and the SLO engine run a report there."""
    assert set(OBSERVABILITY_MODULES) <= set(_all_modules())
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {OBSERVABILITY_MODULES!r}: importlib.import_module(m)\n"
        "import optuna_tpu_torch as ot\n"
        "from optuna_tpu_torch import autopilot, health, slo, telemetry\n"
        "study = ot.create_study()\n"
        "assert health.report_for_study(study)['healthy']\n"
        "assert autopilot.export_report()['autopilots'] == []\n"
        "assert slo.export_report()['enabled'] is False\n"
        "assert telemetry.render_prometheus() == '\\n'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO, timeout=120
    )
    assert out.returncode == 0, out.stderr
