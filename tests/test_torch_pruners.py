"""The port's pruners (``optuna_tpu_torch/pruners/``) against the
reference's (``optuna_tpu/pruners/``): the same prune-or-keep decision at
every step on the same seeded intermediate streams, Hyperband's bracket ids
equal, and the bracket-restricted view that Hyperband gives the sampler.
All host logic on both sides, so decisions are compared exactly."""

from __future__ import annotations

import datetime
import warnings

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
from tests._torch_port import reference_tpe_draws  # noqa: F401

_NOW = datetime.datetime(2026, 1, 1)

optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)
optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)


def _seed_history(mod, study, n_trials: int, n_steps: int, seed: int) -> None:
    """Complete ``n_trials`` trials with seeded stepped curves."""
    rng = np.random.RandomState(seed)
    for i in range(n_trials):
        base = rng.uniform(0.0, 1.0)
        curve = {s: float(base + 0.1 * s + rng.normal(0, 0.01)) for s in range(n_steps)}
        study.add_trial(
            mod.trial.FrozenTrial(
                number=i, state=mod.trial.TrialState.COMPLETE, value=float(curve[n_steps - 1]),
                datetime_start=_NOW, datetime_complete=_NOW, params={"x": float(rng.uniform())},
                distributions={"x": mod.distributions.FloatDistribution(0.0, 1.0)},
                user_attrs={}, system_attrs={}, intermediate_values=curve, trial_id=i,
            )
        )


def _decisions(mod, pruner, direction: str, probe: list[float], seed: int, n_history: int = 12,
               n_steps: int = 8) -> list[bool]:
    # A fixed name: Hyperband hashes it into the trial's bracket.
    study = mod.create_study(
        study_name="pruning", direction=direction, pruner=pruner, sampler=mod.samplers.RandomSampler(seed=0)
    )
    _seed_history(mod, study, n_history, n_steps, seed)
    trial = study.ask()
    out = []
    for step, v in enumerate(probe):
        trial.report(v, step)
        out.append(trial.should_prune())
    study.tell(trial, probe[-1])
    return out


PROBES = [
    [0.9, 1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6],  # consistently bad
    [0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45],  # consistently good
    [0.5, 0.52, 0.55, 0.6, 0.62, 0.64, 0.7, 0.75],  # middling
    [0.5, float("nan"), 0.6, 0.7, 0.8, 0.9, 1.0, 1.1],  # a NaN report
]

PRUNERS = {
    "nop": lambda m: m.pruners.NopPruner(),
    "median": lambda m: m.pruners.MedianPruner(n_startup_trials=4, n_warmup_steps=1),
    "percentile": lambda m: m.pruners.PercentilePruner(25.0, n_startup_trials=4),
    "sha": lambda m: m.pruners.SuccessiveHalvingPruner(min_resource=1, reduction_factor=2),
    "sha-auto": lambda m: m.pruners.SuccessiveHalvingPruner(),
    "sha-rate": lambda m: m.pruners.SuccessiveHalvingPruner(min_resource=1, reduction_factor=3,
                                                            min_early_stopping_rate=1),
    "hyperband": lambda m: m.pruners.HyperbandPruner(min_resource=1, max_resource=8, reduction_factor=2),
    "hyperband-auto": lambda m: m.pruners.HyperbandPruner(),
    "threshold": lambda m: m.pruners.ThresholdPruner(upper=1.05),
    "threshold-warmup": lambda m: m.pruners.ThresholdPruner(lower=0.2, n_warmup_steps=2, interval_steps=2),
    "patient": lambda m: m.pruners.PatientPruner(m.pruners.MedianPruner(n_startup_trials=4), patience=2),
    "patient-alone": lambda m: m.pruners.PatientPruner(None, patience=1, min_delta=0.01),
}


@pytest.mark.parametrize("name", sorted(PRUNERS))
@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_decisions_match_reference(name, direction):
    for i, probe in enumerate(PROBES):
        got = _decisions(optuna_tpu_torch, PRUNERS[name](optuna_tpu_torch), direction, probe, seed=11 + i)
        want = _decisions(optuna_tpu, PRUNERS[name](optuna_tpu), direction, probe, seed=11 + i)
        assert got == want, (name, direction, i)


def test_nop_never_prunes():
    assert not any(_decisions(optuna_tpu_torch, optuna_tpu_torch.pruners.NopPruner(), "minimize", PROBES[0], 3))


def test_wilcoxon_decisions_match_reference():
    def run(mod):
        study = mod.create_study(
            pruner=mod.pruners.WilcoxonPruner(p_threshold=0.1, n_startup_steps=2),
            sampler=mod.samplers.RandomSampler(seed=0),
        )
        rng = np.random.RandomState(5)
        for i in range(6):
            curve = {s: float(rng.uniform(0.2, 0.4)) for s in range(10)}
            study.add_trial(
                mod.trial.FrozenTrial(
                    number=i, state=mod.trial.TrialState.COMPLETE, value=float(np.mean(list(curve.values()))),
                    datetime_start=_NOW, datetime_complete=_NOW, params={"x": 0.5},
                    distributions={"x": mod.distributions.FloatDistribution(0, 1)},
                    user_attrs={}, system_attrs={}, intermediate_values=curve, trial_id=i,
                )
            )
        out = []
        for lo, hi, seed in ((0.5, 0.9, 6), (0.1, 0.3, 7), (0.25, 0.4, 8)):
            trial = study.ask()
            rng2 = np.random.RandomState(seed)
            for step in range(10):
                trial.report(float(rng2.uniform(lo, hi)), step)
                out.append(trial.should_prune())
            study.tell(trial, float(np.mean([lo, hi])))
        return out

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert run(optuna_tpu_torch) == run(optuna_tpu)


def test_hyperband_bracket_ids_match_reference():
    for name, n_brackets_args in (("study-a", (1, 27, 3)), ("bench", (1, 81, 3)), ("x", (2, 64, 2))):
        ids = []
        for mod in (optuna_tpu, optuna_tpu_torch):
            pruner = mod.pruners.HyperbandPruner(*n_brackets_args)
            study = mod.create_study(study_name=name, pruner=pruner, sampler=mod.samplers.RandomSampler(seed=0))
            pruner._try_initialization(study)
            trial = study.ask()
            frozen = study._storage.get_trial(trial._trial_id)
            ids.append((pruner._n_brackets, [_bracket(pruner, study, frozen, n) for n in range(200)]))
        assert ids[0] == ids[1]
        assert len(set(ids[0][1])) == ids[0][0]  # every bracket is drawn


def _bracket(pruner, study, frozen, number: int) -> int:
    original = frozen.number
    try:
        frozen.number = number
        return pruner._get_bracket_id(study, frozen)
    finally:
        frozen.number = original


def test_lazy_exports():
    for name in ("PatientPruner", "ThresholdPruner", "SuccessiveHalvingPruner", "HyperbandPruner", "WilcoxonPruner"):
        assert getattr(optuna_tpu_torch.pruners, name).__module__.startswith("optuna_tpu_torch.pruners.")
    assert set(optuna_tpu_torch.pruners.__all__) == set(optuna_tpu.pruners.__all__)


def _stepped(mod):
    """The pruner tests' stepped curve: a level set by ``x`` and ``k``,
    rising 0.1 a step."""

    def objective(trial) -> float:
        x = trial.suggest_float("x", 0.0, 1.0)
        k = trial.suggest_int("k", 0, 3)
        for step in range(9):
            trial.report(x + 0.1 * step + 0.01 * k, step)
            if trial.should_prune():
                raise mod.TrialPruned()
        return x + 0.8 + 0.01 * k

    return objective


@pytest.mark.usefixtures("reference_tpe_draws")
def test_hyperband_tpe_study_matches_reference_and_sees_only_its_bracket(monkeypatch):
    """A TPE study under HyperbandPruner, trial for trial against the
    reference, with the reference's draws; every trial list the sampler
    reads through ``_filter_study`` holds only the asking trial's bracket."""
    from optuna_tpu_torch.pruners import _hyperband

    seen = []
    real = _hyperband._BracketStudy._get_trials

    def spy(self, *args, **kwargs):
        trials = real(self, *args, **kwargs)
        seen.append((self._bracket_id, [self._pruner._get_bracket_id(self._study, t) for t in trials]))
        return trials

    monkeypatch.setattr(_hyperband._BracketStudy, "_get_trials", spy)
    studies = []
    for mod, kwargs in ((optuna_tpu, {}), (optuna_tpu_torch, {"device": "cpu"})):
        study = mod.create_study(
            study_name="hyperband-tpe",
            sampler=mod.samplers.TPESampler(seed=0, n_startup_trials=6, **kwargs),
            pruner=mod.pruners.HyperbandPruner(min_resource=1, max_resource=9, reduction_factor=3),
        )
        study.optimize(_stepped(mod), n_trials=30)
        studies.append(study)
    ref, port = studies
    assert [t.state.name for t in port.trials] == [t.state.name for t in ref.trials]
    assert any(t.state.name == "PRUNED" for t in port.trials)
    for r, p in zip(ref.trials, port.trials):
        assert r.params["k"] == p.params["k"]
        assert abs(r.params["x"] - p.params["x"]) <= 5e-5
        assert dict(r.intermediate_values).keys() == dict(p.intermediate_values).keys()
    assert seen and all(all(b == bracket for b in ids) for bracket, ids in seen)
    pruner = port.pruner
    for t in port.trials:
        assert pruner._get_bracket_id(port, t) == _crc32_bracket(pruner, "hyperband-tpe", t.number)


def _crc32_bracket(pruner, study_name: str, number: int) -> int:
    import zlib

    n = zlib.crc32(f"{study_name}_{number}".encode()) % pruner._total_trial_allocation_budget
    for bracket_id, budget in enumerate(pruner._trial_allocation_budgets):
        n -= budget
        if n < 0:
            return bracket_id
    raise AssertionError
