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


@pytest.mark.parametrize("module", ["matern", "nds", "wfg"])
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
