"""``run.py`` refuses to measure without a card or without the measured
package, and a whole run, with the look for a card skipped, comes out
correct on sound code and not correct with a fault planted underneath."""

from __future__ import annotations

import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import harness

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "mlp_mnist.b256", "--seed", "2147483659",
         "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
    )


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode == 3 and out.stdout == ""


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def small() -> tuple[dict, dict]:
    """The cell's configuration and traffic at a size the CPU runs in
    seconds; widths, search space, sampler and limits as committed."""
    _, config, traffic = harness.resolve(harness.load_manifest(), "mlp_mnist.b256")
    config = dict(config, n_examples=256, study_trials=768, judge=dict(config["judge"], trials=64, batches=3))
    return config, dict(traffic, batch_size=128)


def run_small(seed: int = 4_294_967_311) -> dict:
    config, traffic = small()
    return harness.run_cell(
        "mlp_mnist.b256", seed, 2.0, False, t_start=time.monotonic(), device="cpu", config=config, traffic=traffic
    )


def _unchanged_step(params, x, y, lr, loss=None):
    from optuna_tpu_torch.models.mlp import cross_entropy, mlp_forward

    return params, (loss or cross_entropy)(mlp_forward(params, x), y).detach()


def _half_batch(original):
    def train(base, x, y, lr, init_scale, n_steps, loss=None):
        half = x.shape[0] // 2
        return original(base, x[:half], y[:half], lr, init_scale, n_steps)

    return train


def _altered_loss(original):
    def train(*args, **kwargs):
        return original(*args, **kwargs) * 1.01

    return train


def _rows_altered(share: float):
    """The losses of the last ``share`` of each batch's rows altered by 1 %."""

    def make(original):
        def train(*args, **kwargs):
            out = original(*args, **kwargs)
            first = out.shape[0] - int(round(share * out.shape[0]))
            return torch.cat([out[:first], out[first:] * 1.01])

        return train

    return make


def _uniform_proposals(original):
    """TPE's batch ask replaced by uniform draws in the search space."""

    def sample(self, study, search_space, n):
        if original(self, study, search_space, n) is None:
            return None
        rng = np.random.default_rng(len(study.get_trials(deepcopy=False)))
        out = []
        for _ in range(n):
            row = {}
            for name, d in search_space.items():
                lo, hi = (np.log(d.low), np.log(d.high)) if d.log else (d.low, d.high)
                v = rng.uniform(lo, hi)
                row[name] = float(np.exp(v)) if d.log else float(v)
            out.append(row)
        return out

    return sample


def _unscored_draws(original):
    """The batch ask's first ``k`` draws from l(x), not its ``k`` best."""

    def topk(below, above, space, draws, k, consider_endpoints):
        from optuna_tpu_torch.samplers._tpe import _kernels

        x_num, x_cat, _ = _kernels._score(
            _kernels._joint_mixture(below, space, consider_endpoints),
            _kernels._joint_mixture(above, space, consider_endpoints),
            draws,
        )
        return x_num[0, :k], x_cat[0, :k]

    return topk


def test_sound_run_is_correct():
    result = run_small()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert math.isfinite(result["checks"]["ask_ks"]["value"])
    assert set(result["checks"]) == {"failed_trials", "loss_err_q50_ratio", "loss_err_q85_ratio", "ask_ks"}
    assert list(result)[-1] == "checks"


TPE = "optuna_tpu_torch.samplers._tpe"
# fault: (module[:class], attribute, the attribute's replacement made from it)
FAULTS = {
    "state_unchanged": ("optuna_tpu_torch.models.mlp", "sgd_step", lambda orig: _unchanged_step),
    "half_batch": ("optuna_tpu_torch.models.mlp", "train_scaled_batch", _half_batch),
    "answer_altered": ("optuna_tpu_torch.models.mlp", "train_scaled_batch", _altered_loss),
    "upper_half_rows_altered": ("optuna_tpu_torch.models.mlp", "train_scaled_batch", _rows_altered(0.5)),
    "last_quarter_rows_altered": ("optuna_tpu_torch.models.mlp", "train_scaled_batch", _rows_altered(0.25)),
    "ask_uniform": (f"{TPE}.sampler:TPESampler", "sample_relative_batch", _uniform_proposals),
    "ask_unscored": (f"{TPE}._kernels", "sample_and_score_topk_from_obs", _unscored_draws),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    import importlib

    path, name, make = FAULTS[fault]
    module, _, owner = path.partition(":")
    target = importlib.import_module(module)
    if owner:
        target = getattr(target, owner)
    monkeypatch.setattr(target, name, make(getattr(target, name)))
    result = run_small()
    assert not result["correct"], result["checks"]
