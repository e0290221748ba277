"""Study runtime of the port against the reference, on the CPU.

Where both packages draw from host numpy (RandomSampler, the GPSampler's
startup trials) the runs must be identical trial for trial. Where the
reference would draw from ``jax.random`` (GP asks), the port is held to the
end state: every trial COMPLETE, finite and inside the search space.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch.models.benchmarks import hartmann20

N_STARTUP = 10


def _objective(pkg):
    def objective(trial):
        x = trial.suggest_float("x", -3.0, 3.0)
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        k = trial.suggest_int("k", 1, 9, step=2)
        w = trial.suggest_int("w", 2, 64, log=True)
        q = trial.suggest_float("q", 0.0, 1.0, step=0.25)
        c = trial.suggest_categorical("c", ["a", "b", None, 3])
        if trial.number % 7 == 3:
            raise pkg.TrialPruned()
        if trial.number % 11 == 5:
            raise ValueError("objective failure")
        return (x - 1) ** 2 + math.log10(lr) ** 2 + k + math.log(w) + q + (c == "b")

    return objective


def _summary(study):
    return [(t.number, t.state.name, t.params, t.values) for t in study.get_trials(deepcopy=False)]


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_random_sampler_study_is_trial_for_trial_identical(direction):
    studies = []
    for pkg in (optuna_tpu, optuna_tpu_torch):
        pkg.logging.set_verbosity(pkg.logging.WARNING)
        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=42), direction=direction)
        study.optimize(_objective(pkg), n_trials=30, catch=(ValueError,))
        studies.append(study)
    ref, port = studies
    assert _summary(port) == _summary(ref)
    assert port.best_trial.number == ref.best_trial.number
    assert port.best_params == ref.best_params
    assert [t.number for t in port.best_trials] == [t.number for t in ref.best_trials]


def test_ask_tell_and_add_trial_are_identical():
    studies = []
    for pkg in (optuna_tpu, optuna_tpu_torch):
        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=3))
        study.add_trial(
            pkg.create_trial(
                params={"x": 0.5},
                distributions={"x": pkg.distributions.FloatDistribution(0.0, 1.0)},
                value=2.0,
            )
        )
        for i in range(6):
            trial = study.ask()
            x = trial.suggest_float("x", 0.0, 1.0)
            study.tell(trial, x * (i + 1))
        studies.append(study)
    assert _summary(studies[1]) == _summary(studies[0])


@pytest.fixture(scope="module")
def reference_startup():
    optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)
    study = optuna_tpu.create_study(sampler=optuna_tpu.samplers.GPSampler(seed=0))
    study.optimize(hartmann20, n_trials=N_STARTUP)
    return _summary(study)


def _gp_study(**kwargs):
    optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
    sampler = optuna_tpu_torch.samplers.GPSampler(seed=0, device="cpu", **kwargs)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(hartmann20, n_trials=N_STARTUP + 3)
    return study


@pytest.mark.parametrize(
    "engine,kwargs",
    [("exact", {}), ("sparse", {"n_exact_max": N_STARTUP - 1, "n_inducing": 8})],
)
def test_gp_study_startup_is_identical_and_gp_trials_are_sound(
    engine, kwargs, reference_startup, monkeypatch
):
    from optuna_tpu_torch.gp import fused, sparse

    calls = {"exact": 0, "sparse": 0}
    for mod, name, key in ((fused, "gp_suggest_fused", "exact"), (sparse, "gp_suggest_sparse_fused", "sparse")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)

    study = _gp_study(**kwargs)
    assert _summary(study)[:N_STARTUP] == reference_startup
    assert calls == {"exact": 3 if engine == "exact" else 0, "sparse": 3 if engine == "sparse" else 0}
    for t in study.get_trials(deepcopy=False)[N_STARTUP:]:
        assert t.state == optuna_tpu_torch.TrialState.COMPLETE
        assert math.isfinite(t.value)
        assert all(0.0 <= t.params[f"x{i}"] <= 1.0 for i in range(20))


def test_fitted_state_carries_from_the_reference_into_the_port():
    from optuna_tpu_torch.gp.convert import kernel_params_cache_from_numpy

    dists = {f"x{i}": optuna_tpu.distributions.FloatDistribution(0.0, 1.0) for i in range(20)}
    sig = tuple((name, repr(d)) for name, d in dists.items())
    raw = np.linspace(-1.0, 1.0, 22).astype(np.float32)
    ref_sampler = optuna_tpu.samplers.GPSampler(seed=0)
    assert ref_sampler.restore_fitted_state({"kernel_params_cache": {sig: [raw]}})
    exported = ref_sampler.export_fitted_state()

    port_sampler = optuna_tpu_torch.samplers.GPSampler(seed=0, device="cpu")
    assert port_sampler.restore_fitted_state(kernel_params_cache_from_numpy(exported))
    port_sig = port_sampler._space_signature(
        {n: optuna_tpu_torch.distributions.FloatDistribution(0.0, 1.0) for n in dists}
    )
    assert port_sig == sig
    np.testing.assert_array_equal(port_sampler._kernel_params_cache[sig][0], raw)
    again = port_sampler.export_fitted_state()
    np.testing.assert_array_equal(again["kernel_params_cache"][sig][0], raw)


def test_gp_sampler_refuses_what_this_slice_does_not_carry():
    study = optuna_tpu_torch.create_study(
        sampler=optuna_tpu_torch.samplers.GPSampler(seed=0, device="cpu", n_startup_trials=1),
        directions=["minimize", "minimize"],
    )
    study.optimize(lambda t: (t.suggest_float("x", 0, 1), 1.0), n_trials=1)
    # Several objectives are carried since ROADMAP A2 (LogEHVI): the ask that
    # used to raise completes.
    study.optimize(lambda t: (t.suggest_float("x", 0, 1), 1.0), n_trials=1)
    assert study.trials[-1].state.name == "COMPLETE"
    # n_jobs threads are carried since ROADMAP A1 (the runtime) was ported.
    study.optimize(lambda t: (1.0, 1.0), n_trials=2, n_jobs=2)
    assert [t.state.name for t in study.trials[-2:]] == ["COMPLETE", "COMPLETE"]
