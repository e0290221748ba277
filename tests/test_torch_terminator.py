"""The port's terminator (``optuna_tpu_torch/terminator/``) against the
reference's (``optuna_tpu/terminator/``), on the CPU.

Both packages run the same ``RandomSampler`` studies (bit for bit in
params, the ROADMAP's ground rule), on an objective with a fixed
per-trial noise (sd 0.3), so that the GP's MAP optimum is interior (as in
``tests/test_torch_gp_host.py``). EMMR takes the reference's normals
(``reference_emmr_normals``). Tolerances:

* where a GP is fitted, each package's own fit: the posterior mean and
  variance at the observed points within 1e-3 absolute, the atol of
  ``tests/test_torch_gp_host.py`` (standardized units), on the exact route
  and on the SGPR route (``gp.sparse.N_EXACT_MAX`` and ``N_INDUCING_MAX``
  lowered in both packages, read at call time);
* on one model (the reference's fitted states handed to the port): the
  evaluator's value within 1e-4 of the objective's standard deviation, the
  unit it is reported in. Both posteriors are float32 of one state; the
  variance ``scale - Σv²`` cancels at the observed points, where σ is small,
  and the regret bound takes √β·σ (√β ≈ 4.3 here): measured 2.5e-5;
* the host evaluators (stagnation, static, cross-validation, median) and the
  stopping trial of ``Terminator``/``TerminatorCallback``: equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.gp import sparse as ref_sparse
from optuna_tpu_torch.gp import gp as port_gp
from optuna_tpu_torch.gp import sparse as port_sparse
from optuna_tpu_torch.gp.convert import gp_state_from_numpy
from optuna_tpu_torch.terminator import _evaluators as port_evaluators
from tests._torch_port import np64, one_torch_thread, reference_emmr_normals  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "reference_emmr_normals")

CPU = "cpu"
POSTERIOR_ATOL = 1e-3  # tests/test_torch_gp_host.py
ONE_MODEL_ATOL = 1e-4  # in units of the objective's standard deviation
_OWN_EMMR_NORMALS = port_evaluators._emmr_normals  # before the fixture swaps in the reference's

for _mod in (optuna_tpu, optuna_tpu_torch):
    _mod.logging.set_verbosity(_mod.logging.WARNING)


def _objective(trial):
    x = [trial.suggest_float(f"x{i}", -3, 3) for i in range(3)]
    noise = 0.3 * np.random.RandomState(trial.number).normal()
    return float(np.sin(x[0]) + 0.3 * (x[1] - 0.5) ** 2 - 0.5 * x[2] + noise)


def _studies(n, seed=0, direction="minimize", objective=_objective):
    out = []
    for mod in (optuna_tpu, optuna_tpu_torch):
        study = mod.create_study(sampler=mod.samplers.RandomSampler(seed=seed), direction=direction)
        study.optimize(objective, n_trials=n)
        out.append(study)
    ref, port = out
    assert [t.params for t in ref.trials] == [t.params for t in port.trials]
    assert [t.values for t in ref.trials] == [t.values for t in port.trials]
    return ref, port


def _evaluators(name):
    return getattr(optuna_tpu.terminator, name)(), getattr(optuna_tpu_torch.terminator, name)(device=CPU)


# Route: (n trials, direction, sparse). The sparse cases lower the exact
# threshold to 24 rows and the inducing count to 16 in both packages.
ROUTES = {
    "exact_min_25": (25, "minimize", False),
    "exact_max_40": (40, "maximize", False),
    "sparse_min_40": (40, "minimize", True),
}
GP_EVALUATORS = ["RegretBoundEvaluator", "EMMREvaluator"]


@pytest.fixture
def route(request, monkeypatch):
    n, direction, sparse = ROUTES[request.param]
    if sparse:
        for mod in (ref_sparse, port_sparse):
            monkeypatch.setattr(mod, "N_EXACT_MAX", 24)
            monkeypatch.setattr(mod, "N_INDUCING_MAX", 16)
    return n, direction, sparse


@pytest.mark.parametrize("route", sorted(ROUTES), indirect=True)
@pytest.mark.parametrize("name", GP_EVALUATORS)
def test_gp_evaluators_fit_the_references_posterior(name, route, monkeypatch):
    """Each package fits its own GP: the posteriors at the observed points
    agree within the GP host test's atol, on both engines."""
    n, direction, sparse = route
    ref_study, port_study = _studies(n, direction=direction)
    posteriors = {"ref": [], "port": []}
    fits = {"ref": [], "port": []}
    real_ref_posterior, real_port_posterior = ref_gp.posterior, port_evaluators._posterior_np
    real_ref_fit, real_port_fit = ref_gp.fit_gp, port_gp.fit_gp

    def ref_posterior(state, x, cat):
        out = real_ref_posterior(state, x, cat)
        posteriors["ref"].append(tuple(np64(a) for a in out))
        return out

    def port_posterior(state, X, cat, dev):
        out = real_port_posterior(state, X, cat, dev)
        posteriors["port"].append(tuple(np64(a) for a in out))
        return out

    def spy_fit(side, real):
        def fit(X, y, cat, **kwargs):
            out = real(X, y, cat, **kwargs)
            fits[side].append((np.array(X), np.array(y), np.array(cat), len(out[0].X)))
            return out

        return fit

    monkeypatch.setattr(ref_gp, "posterior", ref_posterior)
    monkeypatch.setattr(port_evaluators, "_posterior_np", port_posterior)
    monkeypatch.setattr(ref_gp, "fit_gp", spy_fit("ref", real_ref_fit))
    monkeypatch.setattr(port_gp, "fit_gp", spy_fit("port", real_port_fit))
    ref_ev, port_ev = _evaluators(name)
    ref_value = ref_ev.evaluate(ref_study.trials, ref_study.direction)
    port_value = port_ev.evaluate(port_study.trials, port_study.direction)
    assert np.isfinite(ref_value) and np.isfinite(port_value)
    assert len(fits["port"]) == len(fits["ref"]) == (2 if name == "EMMREvaluator" else 1)
    for (X, y, cat, rows), (pX, py, pcat, prows) in zip(fits["ref"], fits["port"]):
        np.testing.assert_array_equal(pX, X)  # host inputs bit for bit
        np.testing.assert_array_equal(py, y)
        np.testing.assert_array_equal(pcat, cat)
        assert prows == rows and (rows == 16 if sparse else rows >= len(X))  # the reduced state on the SGPR route
    assert len(posteriors["port"]) == len(posteriors["ref"])
    for (mean, var), (pmean, pvar) in zip(posteriors["ref"], posteriors["port"]):
        np.testing.assert_allclose(pmean[:n], mean[:n], rtol=0, atol=POSTERIOR_ATOL)
        np.testing.assert_allclose(pvar[:n], var[:n], rtol=0, atol=POSTERIOR_ATOL)


@pytest.mark.parametrize("route", sorted(ROUTES), indirect=True)
@pytest.mark.parametrize("name", GP_EVALUATORS)
def test_gp_evaluators_on_one_model_equal_the_reference(name, route, monkeypatch):
    """The reference's fitted states handed to the port: the evaluator's
    arithmetic after the fit equals the reference's."""
    n, direction, _ = route
    ref_study, port_study = _studies(n, seed=1, direction=direction)
    states = []
    real_ref_fit = ref_gp.fit_gp

    def ref_fit(X, y, cat, **kwargs):
        out = real_ref_fit(X, y, cat, **kwargs)
        states.append((np.array(X), np.array(y), out[0]))
        return out

    def port_fit(X, y, cat, device=None, **kwargs):
        rX, ry, state = states.pop(0)
        np.testing.assert_array_equal(X, rX)
        np.testing.assert_array_equal(y, ry)
        return gp_state_from_numpy(state, device), None, {}

    monkeypatch.setattr(ref_gp, "fit_gp", ref_fit)
    monkeypatch.setattr(port_gp, "fit_gp", port_fit)
    ref_ev, port_ev = _evaluators(name)
    ref_value = ref_ev.evaluate(ref_study.trials, ref_study.direction)
    port_value = port_ev.evaluate(port_study.trials, port_study.direction)
    assert not states
    sd = float(np.std([t.value for t in ref_study.trials]))
    assert abs(port_value - ref_value) <= ONE_MODEL_ATOL * sd, (port_value, ref_value)


def test_gp_evaluators_below_their_minimum_and_without_a_varying_param():
    ref_study, port_study = _studies(10)
    for name in GP_EVALUATORS:
        ref_ev, port_ev = _evaluators(name)
        assert ref_ev.evaluate(ref_study.trials, ref_study.direction) == float("inf")
        assert port_ev.evaluate(port_study.trials, port_study.direction) == float("inf")
    ref_fixed, port_fixed = _studies(25, objective=lambda t: t.suggest_float("x", 1.0, 1.0) + t.number)
    for name in GP_EVALUATORS:
        ref_ev, port_ev = _evaluators(name)
        assert ref_ev.evaluate(ref_fixed.trials, ref_fixed.direction) == float("inf")
        assert port_ev.evaluate(port_fixed.trials, port_fixed.direction) == float("inf")


def test_the_gp_evaluators_run_on_the_card_by_default():
    _, port_study = _studies(25)
    if not torch.cuda.is_available():
        for name in GP_EVALUATORS:
            with pytest.raises(RuntimeError, match="no GPU"):
                getattr(optuna_tpu_torch.terminator, name)().evaluate(port_study.trials, port_study.direction)
        with pytest.raises(RuntimeError, match="no GPU"):
            optuna_tpu_torch.terminator.Terminator().should_terminate(port_study)


def test_emmr_normals_are_seeded_cpu_draws():
    a = _OWN_EMMR_NORMALS(4, 7, 3)
    assert a.shape == (4, 7) and a.dtype == np.float32
    np.testing.assert_array_equal(a, _OWN_EMMR_NORMALS(4, 7, 3))
    assert not np.array_equal(a, _OWN_EMMR_NORMALS(4, 7, 4))
    assert port_evaluators._emmr_normals is not _OWN_EMMR_NORMALS  # the fixture's swap is what EMMR calls


# ------------------------------------------------------------ host evaluators


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_host_evaluators_equal_the_reference(direction):
    ref_study, port_study = _studies(45, seed=2, direction=direction)
    cases = [
        ("BestValueStagnationEvaluator", {}),
        ("BestValueStagnationEvaluator", {"max_stagnation_trials": 5}),
        ("StaticErrorEvaluator", {"constant": 0.25}),
        ("MedianErrorEvaluator", {}),
        ("MedianErrorEvaluator", {"warm_up_trials": 3, "n_min_trials": 8, "scale": 2.0}),
    ]
    for name, kwargs in cases:
        for k in (5, 30, 45):
            a = getattr(optuna_tpu.terminator, name)(**kwargs).evaluate(ref_study.trials[:k], ref_study.direction)
            b = getattr(optuna_tpu_torch.terminator, name)(**kwargs).evaluate(
                port_study.trials[:k], port_study.direction
            )
            assert a == b, (name, kwargs, k)
    paired = [
        mod.terminator.MedianErrorEvaluator(
            mod.terminator.BestValueStagnationEvaluator(3), warm_up_trials=2, n_min_trials=5
        )
        for mod in (optuna_tpu, optuna_tpu_torch)
    ]
    assert paired[0].evaluate(ref_study.trials, ref_study.direction) == paired[1].evaluate(
        port_study.trials, port_study.direction
    )
    with pytest.raises(ValueError, match="nonnegative"):
        optuna_tpu_torch.terminator.BestValueStagnationEvaluator(-1)


def _cv_studies():
    out = []
    for mod in (optuna_tpu, optuna_tpu_torch):
        study = mod.create_study(sampler=mod.samplers.RandomSampler(seed=4))

        def objective(trial, mod=mod):
            x = trial.suggest_float("x", 0, 1)
            mod.terminator.report_cross_validation_scores(trial, [x, x + 0.1, x - 0.05 * trial.number])
            return x

        study.optimize(objective, n_trials=6)
        out.append(study)
    return out


def test_report_cross_validation_scores_and_its_error_match_the_reference():
    ref_study, port_study = _cv_studies()
    assert [t.system_attrs for t in ref_study.trials] == [t.system_attrs for t in port_study.trials]
    a = optuna_tpu.terminator.CrossValidationErrorEvaluator().evaluate(ref_study.trials, ref_study.direction)
    b = optuna_tpu_torch.terminator.CrossValidationErrorEvaluator().evaluate(port_study.trials, port_study.direction)
    assert a == b and b > 0
    for mod in (optuna_tpu, optuna_tpu_torch):
        study = mod.create_study(sampler=mod.samplers.RandomSampler(seed=0))
        with pytest.raises(ValueError, match="greater than one"):
            study.optimize(lambda t, mod=mod: mod.terminator.report_cross_validation_scores(t, [1.0]), n_trials=1,
                           catch=())
        study = mod.create_study(sampler=mod.samplers.RandomSampler(seed=0))
        study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=2)
        with pytest.raises(ValueError, match="have not been reported"):
            mod.terminator.CrossValidationErrorEvaluator().evaluate(study.trials, study.direction)
        assert np.isnan(mod.terminator.CrossValidationErrorEvaluator().evaluate([], study.direction))


# ---------------------------------------------------- Terminator and callback


def _stopped_at(mod, terminator_factory, objective, n_trials=100, seed=3):
    study = mod.create_study(sampler=mod.samplers.RandomSampler(seed=seed))
    study.optimize(objective, n_trials=n_trials, callbacks=[mod.terminator.TerminatorCallback(terminator_factory(mod))])
    return len(study.trials)


@pytest.mark.parametrize("k", [0, 3, 8])
def test_terminator_callback_stops_at_the_same_trial(k):
    def factory(mod):
        return mod.terminator.Terminator(
            mod.terminator.BestValueStagnationEvaluator(k), mod.terminator.StaticErrorEvaluator(0.0), min_n_trials=5
        )

    def objective(trial):
        return (trial.suggest_float("x", -1, 1) - 0.3) ** 2

    ref = _stopped_at(optuna_tpu, factory, objective)
    port = _stopped_at(optuna_tpu_torch, factory, objective)
    assert port == ref < 100


def test_terminator_with_the_regret_bound_stops_at_the_same_trial():
    def factory(mod):
        kwargs = {"device": CPU} if mod is optuna_tpu_torch else {}
        return mod.terminator.Terminator(
            mod.terminator.RegretBoundEvaluator(min_n_trials=20, **kwargs),
            mod.terminator.StaticErrorEvaluator(1e9),  # an absurd error: must stop at once
            min_n_trials=20,
        )

    assert _stopped_at(optuna_tpu_torch, factory, _objective, n_trials=40) == _stopped_at(
        optuna_tpu, factory, _objective, n_trials=40
    ) == 20


def test_terminator_defaults_and_validation_match_the_reference():
    for mod in (optuna_tpu, optuna_tpu_torch):
        t = mod.terminator
        stagnation = t.Terminator(t.BestValueStagnationEvaluator())
        assert isinstance(stagnation._error_evaluator, t.StaticErrorEvaluator)
        assert isinstance(t.Terminator()._error_evaluator, t.CrossValidationErrorEvaluator)
        assert isinstance(t.Terminator()._improvement_evaluator, t.RegretBoundEvaluator)
        callback = t.TerminatorCallback()
        assert isinstance(callback._terminator._error_evaluator, t.MedianErrorEvaluator)
        with pytest.raises(ValueError, match="positive integer"):
            t.Terminator(min_n_trials=0)
        study = mod.create_study(sampler=mod.samplers.RandomSampler(seed=0))
        study.optimize(lambda tr: tr.suggest_float("x", 0, 1), n_trials=3)
        assert t.Terminator().should_terminate(study) is False  # below min_n_trials: no evaluator runs
        assert issubclass(t.Terminator, t.BaseTerminator)


def test_the_alias_modules_export_the_references_names():
    import importlib

    for sub in ("", ".callback", ".erroreval", ".median_erroreval", ".terminator", ".improvement",
                ".improvement.evaluator", ".improvement.emmr"):
        ref = importlib.import_module("optuna_tpu.terminator" + sub)
        port = importlib.import_module("optuna_tpu_torch.terminator" + sub)
        assert port.__all__ == ref.__all__, sub
        for name in port.__all__:
            assert getattr(port, name) is getattr(optuna_tpu_torch.terminator, name)
