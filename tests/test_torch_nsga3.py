"""NSGA-III studies of the port against the reference, on the CPU.

As for NSGA-II (``tests/test_torch_nsga.py``): both packages draw every
random number from host numpy (the GA, and the niching draw of
``LazyRandomState``), and dominance is exact, so a study must be identical
trial for trial on both rank routes of the port: the host sort, and the
device branch (the ranking kernels' plain version on the CPU), reached by
lowering ``_DEVICE_RANK_MIN_POINTS``. The objective is DTLZ2 (Deb et al.
2002) on three objectives; the cases cover constraints, user reference
points and ``dividing_parameter``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
import optuna_tpu_torch.ops.pareto as port_pareto
from optuna_tpu.samplers._nsgaiii import _sampler as ref_nsga3
from optuna_tpu_torch.samplers._nsgaiii import _sampler as port_nsga3
from optuna_tpu_torch.study import _multi_objective

POPULATION = 8
GENERATIONS = 5
DIM = 5

optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)
optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)


def dtlz2(trial, dim: int = DIM, m: int = 3):
    xs = [trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(dim)]
    g = sum((x - 0.5) ** 2 for x in xs[m - 1 :])
    out = []
    for i in range(m):
        f = 1.0 + g
        for x in xs[: m - 1 - i]:
            f *= math.cos(x * math.pi / 2)
        if i > 0:
            f *= math.sin(xs[m - 1 - i] * math.pi / 2)
        out.append(f)
    return tuple(out)


def _summary(study):
    trials = [
        (t.number, t.state.name, t.params, t.values, t.system_attrs)
        for t in study.get_trials(deepcopy=False)
    ]
    return trials, study._storage.get_study_system_attrs(study._study_id)


def _constraints(trial):
    return [trial.params["x1"] - 0.7, 0.1 - trial.params["x0"]]


USER_POINTS = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.4, 0.3, 0.3]])


def _run(pkg, *, constrained: bool, variant: str, **port_kwargs):
    kwargs = dict(seed=0, population_size=POPULATION, **port_kwargs)
    if constrained:
        kwargs["constraints_func"] = _constraints
    if variant == "user-points":
        kwargs["reference_points"] = USER_POINTS
    elif variant == "dividing-5":
        kwargs["dividing_parameter"] = 5
    sampler = pkg.samplers.NSGAIIISampler(**kwargs)
    study = pkg.create_study(directions=["minimize"] * 3, sampler=sampler)
    study.optimize(dtlz2, n_trials=POPULATION * GENERATIONS)
    return study


@pytest.mark.parametrize("device_branch", [False, True], ids=["host-sort", "device-branch"])
@pytest.mark.parametrize(
    "constrained,variant",
    [(False, "default"), (True, "default"), (False, "user-points"), (False, "dividing-5")],
)
def test_nsga3_dtlz2_is_trial_for_trial_identical(monkeypatch, device_branch, constrained, variant):
    calls = []
    threshold = 8 if constrained else 2 * POPULATION
    if device_branch:
        monkeypatch.setattr(_multi_objective, "_DEVICE_RANK_MIN_POINTS", threshold)
        rank_np = port_pareto.non_domination_rank_np
        monkeypatch.setattr(
            port_pareto, "non_domination_rank_np",
            lambda values, *, device=None: calls.append(len(values)) or rank_np(values, device=device),
        )
    ref = _run(optuna_tpu, constrained=constrained, variant=variant)
    port = _run(optuna_tpu_torch, constrained=constrained, variant=variant, device="cpu")
    assert _summary(port) == _summary(ref)
    assert {t.state for t in port.get_trials(deepcopy=False)} == {optuna_tpu_torch.TrialState.COMPLETE}
    assert len([k for k in _summary(port)[1] if ":population|" in k]) == GENERATIONS - 1
    if device_branch:
        assert len(calls) >= GENERATIONS - 2 and min(calls) >= threshold


@pytest.mark.parametrize("m,p", [(2, 3), (3, 3), (3, 5), (5, 2)])
def test_default_reference_points_equal_the_reference(m, p):
    got = port_nsga3.generate_default_reference_point(m, p)
    np.testing.assert_array_equal(got, ref_nsga3.generate_default_reference_point(m, p))
    np.testing.assert_allclose(got.sum(axis=1), 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_associate_and_niching_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    values = rng.uniform(size=(30, 3)) ** 2
    refs = port_nsga3.generate_default_reference_point(3, 4)
    norm = port_nsga3._normalize_objectives(values)
    np.testing.assert_array_equal(norm, ref_nsga3._normalize_objectives(values))
    idx, dist = port_nsga3._associate(norm, refs)
    want_idx, want_dist = ref_nsga3._associate(norm, refs)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(dist, want_dist)
    picks = [
        mod._niching_select(list(range(10)), list(range(10, 30)), 7, idx, dist, len(refs), np.random.RandomState(seed))
        for mod in (port_nsga3, ref_nsga3)
    ]
    assert picks[0] == picks[1] and len(set(picks[0])) == 7


def test_device_is_resolved_only_where_a_large_pool_is_ranked():
    sampler = optuna_tpu_torch.samplers.NSGAIIISampler(seed=0, population_size=4)
    assert sampler._device is None
    study = optuna_tpu_torch.create_study(directions=["minimize"] * 3, sampler=sampler)
    study.optimize(dtlz2, n_trials=16)  # pools of 8 < 512: the host sort, no card needed
    assert len(study.best_trials) >= 1
    assert optuna_tpu_torch.samplers.NSGAIIISampler(device="cpu")._device.type == "cpu"
