"""The GP sampler's host routes on the CPU: every one of them raised
``NotImplementedError`` before the port carried them.

* ``n_jobs=2`` with an objective that sleeps: every ask after the first
  finds the other worker's trial RUNNING and fantasizes it (qLogEI);
* constraints (the reference's ``test_gp_sampler_constraints``): the best
  trial is feasible;
* two and three objectives through LogEHVI;
* the sparse host fit (``fit_gp_sparse``, K1's plain version on the CPU)
  above ``n_exact_max=32``, under constraints and with running trials;
* the end state against the reference: the startup trials are the
  reference's trial for trial (one ``RandomSampler`` seed on both sides),
  and the port's study completes every trial after them.

The acquisition pools are small (``n_preliminary_samples`` 64–128,
``n_local_search`` 2–4) to keep the CPU time down; the routes do not depend
on the pools' sizes.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import TrialState
from optuna_tpu_torch.gp import sparse as port_sparse
from optuna_tpu_torch.samplers import GPSampler
from tests._torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)
CPU = "cpu"


def _counting(monkeypatch, owner, name):
    calls = []
    real = getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, spy)
    return calls


def _all_complete(study, n):
    states = [t.state for t in study.trials]
    return len(states) == n and all(s == TrialState.COMPLETE for s in states)


def test_n_jobs_asks_fantasize_the_running_trials(monkeypatch):
    """The regression (10 trials in the report; 8 here): with two workers
    and a 0.3 s objective, an ask
    finds the other worker's trial RUNNING with its params set; it used to
    raise and abort the study."""
    qlogei = _counting(monkeypatch, GPSampler, "_build_qlogei")

    def objective(trial):
        x = trial.suggest_float("x", -2.0, 2.0)
        y = trial.suggest_float("y", -2.0, 2.0)
        time.sleep(0.3)
        return x * x + y * y

    sampler = GPSampler(seed=0, device=CPU, n_startup_trials=4, n_preliminary_samples=128, n_local_search=2)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(objective, n_trials=8, n_jobs=2)
    assert _all_complete(study, 8)
    assert len(qlogei) >= 1


def test_constraints_keep_the_best_trial_feasible(monkeypatch):
    fits = _counting(monkeypatch, GPSampler, "_wrap_constraints")

    def cons(trial):
        return (trial.params["x"] - 1.0,)

    sampler = GPSampler(seed=2, device=CPU, n_startup_trials=6, constraints_func=cons, n_preliminary_samples=128)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(lambda t: -t.suggest_float("x", 0, 10), n_trials=20)
    assert _all_complete(study, 20) and len(fits) == 14
    assert study.best_trial.params["x"] <= 1.0 + 1e-6
    assert all(t.system_attrs["constraints"] == (t.params["x"] - 1.0,) for t in study.trials)


@pytest.mark.parametrize("n_objectives", [2, 3])
def test_several_objectives_go_through_logehvi(monkeypatch, n_objectives):
    ehvi = _counting(monkeypatch, GPSampler, "_build_logehvi")

    def mo(t):
        x = t.suggest_float("x", 0, 1)
        y = t.suggest_float("y", 0, 1)
        values = (x, (1 + y) * (1 - x**0.5))
        return values if n_objectives == 2 else values + (y + 0.5 * x,)

    sampler = GPSampler(seed=3, device=CPU, n_startup_trials=6, n_preliminary_samples=64, n_local_search=2)
    study = optuna_tpu_torch.create_study(directions=["minimize"] * n_objectives, sampler=sampler)
    n_trials = 10 if n_objectives == 2 else 9
    study.optimize(mo, n_trials=n_trials)
    assert _all_complete(study, n_trials) and len(ehvi) == n_trials - 6
    assert len(study.best_trials) >= 3
    sig = next(iter(sampler._kernel_params_cache))
    assert len(sampler._kernel_params_cache[sig]) == n_objectives


def _constrained_history(n, sampler):
    from optuna_tpu_torch.distributions import FloatDistribution

    rng = np.random.RandomState(0)
    dists = {"x": FloatDistribution(-2.0, 2.0), "y": FloatDistribution(-2.0, 2.0)}
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.add_trials(
        optuna_tpu_torch.create_trial(
            params={"x": float(a), "y": float(b)}, distributions=dists, value=float(a * a + b * b),
            system_attrs={"constraints": (float(a + b),)},
        )
        for a, b in rng.uniform(-2, 2, size=(n, 2))
    )
    return study


def _sphere(t):
    x = t.suggest_float("x", -2.0, 2.0)
    y = t.suggest_float("y", -2.0, 2.0)
    return x * x + y * y


def test_the_sparse_host_fit_takes_histories_above_n_exact_max(monkeypatch):
    """40 trials above ``n_exact_max=32``: the objective's host fit is the
    SGPR fit on 16 inducing points; the constraint's GP keeps the module
    threshold (1024), as the reference's ``_wrap_constraints`` does. On the
    CPU the reduction runs K1's plain version: no launch."""
    from optuna_tpu_torch.ops.kernels import matern

    sparse_fits = _counting(monkeypatch, port_sparse, "fit_gp_sparse")
    launches = matern.LAUNCHES
    sampler = GPSampler(
        seed=0, device=CPU, n_startup_trials=4, n_exact_max=32, n_inducing=16,
        constraints_func=lambda t: (t.params["x"] + t.params["y"],), n_preliminary_samples=64,
    )
    study = _constrained_history(40, sampler)
    study.optimize(_sphere, n_trials=2)
    assert _all_complete(study, 42) and len(sparse_fits) == 2
    assert matern.LAUNCHES == launches


def test_the_sparse_host_fit_under_running_trials(monkeypatch):
    qlogei = _counting(monkeypatch, GPSampler, "_build_qlogei")
    sparse_fits = _counting(monkeypatch, port_sparse, "fit_gp_sparse")
    sampler = GPSampler(seed=0, device=CPU, n_startup_trials=4, n_exact_max=32, n_inducing=16, n_preliminary_samples=64)
    study = _constrained_history(40, sampler)
    running = study.ask({"x": optuna_tpu_torch.distributions.FloatDistribution(-2.0, 2.0),
                         "y": optuna_tpu_torch.distributions.FloatDistribution(-2.0, 2.0)})
    study.optimize(_sphere, n_trials=1)
    study.tell(running, 1.0)
    assert len(qlogei) == 1 and len(sparse_fits) == 1
    assert all(t.state == TrialState.COMPLETE for t in study.trials)


ROUTES = {
    "constraints": dict(constraints_func=lambda t: (t.params["x"] - 0.5,)),
    "two objectives": dict(),
    "chain": dict(speculative_chain=4),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_end_state_against_the_reference(route):
    """Five startup trials equal to the reference's trial for trial (the
    reference runs no further: its GP asks would cost JAX compiles), then
    two GP trials on the port: all COMPLETE, finite and in the box."""
    from optuna_tpu.samplers import GPSampler as RefGPSampler

    n_obj = 2 if route == "two objectives" else 1

    def objective(t):
        x = t.suggest_float("x", -1.0, 1.0)
        y = t.suggest_float("y", -1.0, 1.0)
        return (x * x + y, (x - 0.5) ** 2 - y) if n_obj == 2 else (x - 0.2) ** 2 + y * y

    kw = dict(seed=7, n_startup_trials=5, n_preliminary_samples=64, n_local_search=2, **ROUTES[route])
    ref = optuna_tpu.create_study(sampler=RefGPSampler(**kw), directions=["minimize"] * n_obj)
    ref.optimize(objective, n_trials=5)
    port = optuna_tpu_torch.create_study(sampler=GPSampler(device=CPU, **kw), directions=["minimize"] * n_obj)
    port.optimize(objective, n_trials=7)
    assert [t.params for t in port.trials[:5]] == [t.params for t in ref.trials]
    assert [t.values for t in port.trials[:5]] == [t.values for t in ref.trials]
    assert _all_complete(port, 7)
    for t in port.trials[5:]:
        assert all(np.isfinite(t.values)) and all(-1.0 <= v <= 1.0 for v in t.params.values())
