"""The port's TPESampler (``optuna_tpu_torch/samplers/_tpe/sampler.py``)
against the reference's (``optuna_tpu/samplers/_tpe/sampler.py``).

- The split of the history into below and above is host logic in both, and
  is held bit for bit: the same trials on each side.
- Studies run trial for trial, with the reference's draws handed to the
  port's draw step (``tests/_torch_port.py::reference_tpe_draws``). The
  startup trials are host NumPy on both sides and equal bit for bit. Past
  them the argmax must pick the same candidate: the same categorical and
  integer values, and float values within ``PARAM_TOL`` of the transformed
  width (log dims in log space). The two frameworks' float32 truncated-
  normal ``ppf`` differ by up to 3.4e-5 in standard units
  (``tests/test_torch_truncnorm.py``); on these studies the largest gap
  seen was 1.7e-6 absolute, 3e-7 of a width, and no choice flipped.
"""

from __future__ import annotations

import datetime
import math

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.models import benchmarks as ref_benchmarks
from optuna_tpu.samplers._tpe import sampler as ref_tpe
from optuna_tpu_torch.models import benchmarks as port_benchmarks
from optuna_tpu_torch.samplers._tpe import sampler as port_tpe
from tests._torch_port import reference_tpe_draws  # noqa: F401

PARAM_TOL = 5e-5
SCORE_TIE_TOL = 1e-5
_NOW = datetime.datetime(2026, 1, 1)

optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)
optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)


def _transformed(dist, value: float) -> float:
    return math.log(value) if getattr(dist, "log", False) else float(value)


@pytest.fixture
def port_scores(monkeypatch):
    """Every (P, S) score array the port's asks compute, with the trial and
    the space of the ask: ``(trial number, spec, joint, (x_num, x_cat, score))``."""
    from optuna_tpu_torch.samplers._tpe import _kernels

    records, state = [], {}
    cls = port_tpe.TPESampler
    relative, independent, sample, score = cls.sample_relative, cls.sample_independent, cls._sample, _kernels._score

    def on_relative(self, study, trial, search_space):
        state["trial"] = trial.number
        return relative(self, study, trial, search_space)

    def on_independent(self, study, trial, name, dist):
        state["trial"] = trial.number
        return independent(self, study, trial, name, dist)

    def on_sample(self, study, search_space, joint):
        state["space"] = (self._univariate_space_spec(search_space), joint)
        return sample(self, study, search_space, joint)

    def on_score(below, above, draws):
        out = score(below, above, draws)
        records.append((state["trial"], *state["space"], out))
        return out

    monkeypatch.setattr(cls, "sample_relative", on_relative)
    monkeypatch.setattr(cls, "sample_independent", on_independent)
    monkeypatch.setattr(cls, "_sample", on_sample)
    monkeypatch.setattr(_kernels, "_score", on_score)
    return records


def _same_float(dist, a: float, b: float) -> bool:
    lo, hi = _transformed(dist, dist.low), _transformed(dist, dist.high)
    return abs(_transformed(dist, a) - _transformed(dist, b)) / (hi - lo) <= PARAM_TOL


def _same_value(dist, a, b) -> bool:
    if isinstance(a, float) and not isinstance(dist, optuna_tpu.distributions.IntDistribution):
        return _same_float(dist, a, b)
    return a == b


def _is_near_tie(ref_trial, records) -> bool:
    """Whether the reference's choice at ``ref_trial`` is one of the port's
    own candidates at that ask, scored within ``SCORE_TIE_TOL`` of the
    port's best: a tie the two frameworks' float32 sums break apart."""
    from optuna_tpu_torch.samplers._tpe.parzen_estimator import _from_transformed

    recs = [r for r in records if r[0] == ref_trial.number]
    assert recs, f"no port ask recorded for trial {ref_trial.number}"
    for _, spec, joint, (x_num, x_cat, score) in recs:
        x_num, x_cat, score = x_num.cpu().numpy(), x_cat.cpu().numpy(), score.cpu().double().numpy()

        def matches(p: int, s: int, dims) -> bool:
            for kind, d, (name, dist) in dims:
                want = dist.to_internal_repr(ref_trial.params[name])
                if kind == "num":
                    got = _from_transformed(dist, float(x_num[p, s, d]))
                    if not _same_value(dist, dist.to_external_repr(got), ref_trial.params[name]):
                        return False
                elif int(x_cat[p, s, d]) != int(want):
                    return False
            return True

        num = [("num", i, item) for i, item in enumerate(spec["num_items"])]
        cat = [("cat", i, item) for i, item in enumerate(spec["cat_items"])]
        if joint:
            problems = [(0, num + cat)]
        elif x_num.shape[2] == 1:  # univariate numerical problems, one per dim
            problems = [(p, [("num", 0, item)]) for p, item in enumerate(spec["num_items"])]
        else:
            problems = [(p, [("cat", 0, item)]) for p, item in enumerate(spec["cat_items"])]
        for p, dims in problems:
            best = score[p].max()
            tol = SCORE_TIE_TOL * max(1.0, abs(best))
            if not any(matches(p, s, dims) and score[p, s] >= best - tol for s in range(score.shape[1])):
                return False
    return True


def assert_same_study(ref_study, port_study, records, n_startup: int = 10) -> int | None:
    """Trial for trial: the startup trials bit for bit; later trials the same
    choices and floats within ``PARAM_TOL`` of each transformed width, until
    a trial where the choices part, which must be a near tie
    (:func:`_is_near_tie`) and ends the comparison: the histories differ
    from there. Returns that trial's number, or None."""
    ref_trials, port_trials = ref_study.trials, port_study.trials
    assert len(ref_trials) == len(port_trials)
    for r, p in zip(ref_trials, port_trials):
        assert r.state.name == p.state.name and set(r.params) == set(p.params), r.number
        if r.number < n_startup:
            assert r.params == p.params, r.number
            continue
        if not all(_same_value(r.distributions[k], v, p.params[k]) for k, v in r.params.items()):
            assert _is_near_tie(r, records), f"trial {r.number} parts without a near tie: {r.params} {p.params}"
            return r.number
    return None


# ------------------------------------------------------------ the defaults


@pytest.mark.parametrize("n", [0, 1, 9, 10, 24, 25, 26, 100, 300, 1000])
def test_gamma_and_weights_match_reference(n):
    assert port_tpe.default_gamma(n) == ref_tpe.default_gamma(n)
    assert port_tpe.hyperopt_default_gamma(n) == ref_tpe.hyperopt_default_gamma(n)
    np.testing.assert_array_equal(port_tpe.default_weights(n), ref_tpe.default_weights(n))


def test_create_study_default_is_tpe_on_the_card():
    study = optuna_tpu_torch.create_study()
    assert isinstance(study.sampler, port_tpe.TPESampler)
    multi = optuna_tpu_torch.create_study(directions=["minimize", "maximize"])
    assert not isinstance(multi.sampler, port_tpe.TPESampler)
    if torch.cuda.is_available():
        assert study.sampler.device.type == "cuda"
    else:
        # No GPU and no device: the first ask raises, nothing moves to the CPU.
        with pytest.raises(RuntimeError, match="no GPU"):
            study.optimize(port_benchmarks.branin, n_trials=1)
    assert port_tpe.TPESampler(device="cpu").device.type == "cpu"


def test_motpe_sampler_is_deprecated_with_the_paper_defaults():
    with pytest.warns(FutureWarning):
        sampler = optuna_tpu_torch.samplers.MOTPESampler(seed=0, device="cpu")
    assert isinstance(sampler, optuna_tpu_torch.samplers.TPESampler)
    assert sampler._parzen_estimator_parameters.consider_endpoints is True


# --------------------------------------------------------------- the split


def _history(mod, *, n: int, directions: int, seed: int, constraints: bool, running: int):
    """A seeded history: COMPLETE, PRUNED with and without intermediate
    values (one NaN), RUNNING, and (with ``constraints``) feasible and
    infeasible trials. Values repeat, so ties are split by trial order."""
    rng = np.random.RandomState(seed)
    dist = mod.distributions.FloatDistribution(0.0, 1.0)
    trials = []
    for i in range(n + running):
        kind = "running" if i >= n else rng.choice(["complete"] * 6 + ["pruned_iv", "pruned"])
        system_attrs = {}
        if constraints:
            system_attrs["constraints"] = [float(rng.choice([-1.0, 0.0, 0.5, 2.0]))]
        values = [float(np.round(rng.uniform(), 1)) for _ in range(directions)]
        iv = {}
        state = mod.trial.TrialState.COMPLETE
        if kind == "pruned_iv":
            state = mod.trial.TrialState.PRUNED
            iv = {s: float(rng.uniform()) for s in range(int(rng.randint(1, 4)))}
            if rng.uniform() < 0.2:
                iv[max(iv)] = float("nan")
            values = None
        elif kind == "pruned":
            state, values = mod.trial.TrialState.PRUNED, None
        elif kind == "running":
            state, values = mod.trial.TrialState.RUNNING, None
        trials.append(
            mod.trial.FrozenTrial(
                number=i, state=state, value=None, values=values,
                datetime_start=_NOW, datetime_complete=None if kind == "running" else _NOW,
                params={"x": float(rng.uniform())}, distributions={"x": dist},
                user_attrs={}, system_attrs=system_attrs, intermediate_values=iv, trial_id=i,
            )
        )
    return trials


SPLITS = [
    # (directions, n trials, n_below, constraints, running)
    (["minimize"], 60, 6, False, 0),
    (["maximize"], 60, 30, False, 0),
    (["minimize"], 80, 8, True, 0),
    (["maximize"], 40, 4, True, 5),
    (["minimize", "maximize"], 120, 12, False, 0),
    (["minimize", "minimize"], 90, 25, True, 3),
]


@pytest.mark.parametrize("directions, n, n_below, constraints, running", SPLITS)
def test_split_trials_matches_reference_bit_for_bit(directions, n, n_below, constraints, running):
    out = {}
    for mod, split in ((optuna_tpu, ref_tpe._split_trials), (optuna_tpu_torch, port_tpe._split_trials)):
        study = mod.create_study(directions=directions, sampler=mod.samplers.RandomSampler(seed=0))
        trials = _history(mod, n=n, directions=len(directions), seed=n, constraints=constraints, running=running)
        kwargs = {"device": "cpu"} if mod is optuna_tpu_torch else {}
        below, above = split(study, trials, n_below, constraints, **kwargs)
        out[mod.__name__] = ([t.number for t in below], [t.number for t in above])
    assert out["optuna_tpu_torch"] == out["optuna_tpu"]
    assert len(out["optuna_tpu"][0]) > 0


def test_motpe_split_ranks_512_trials_as_the_reference():
    """From 512 complete feasible trials the port ranks through K2's route
    (its plain peeling loop on the CPU); the reference through its own
    device ranking. The split, and the below weights, are the same."""
    out = {}
    for mod, split in ((optuna_tpu, ref_tpe._split_trials), (optuna_tpu_torch, port_tpe._split_trials)):
        study = mod.create_study(directions=["minimize", "minimize"], sampler=mod.samplers.RandomSampler(seed=0))
        trials = _history(mod, n=700, directions=2, seed=7, constraints=False, running=0)
        kwargs = {"device": "cpu"} if mod is optuna_tpu_torch else {}
        below, above = split(study, trials, 25, False, **kwargs)
        weigh = (
            ref_tpe._calculate_weights_below_for_multi_objective
            if mod is optuna_tpu
            else lambda s, b: port_tpe._calculate_weights_below_for_multi_objective(s, b, device="cpu")
        )
        out[mod.__name__] = ([t.number for t in below], [t.number for t in above], weigh(study, below))
    got, want = out["optuna_tpu_torch"], out["optuna_tpu"]
    assert sum(t.state.name == "COMPLETE" for t in _history(optuna_tpu, n=700, directions=2, seed=7,
                                                             constraints=False, running=0)) >= 512
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


# ---------------------------------------------------- studies, trial for trial


def _run_both(objective_name: str, n_trials: int):
    ref_study = optuna_tpu.create_study(sampler=optuna_tpu.samplers.TPESampler(seed=0))
    ref_study.optimize(getattr(ref_benchmarks, objective_name), n_trials=n_trials)
    port_study = optuna_tpu_torch.create_study(sampler=port_tpe.TPESampler(seed=0, device="cpu"))
    port_study.optimize(getattr(port_benchmarks, objective_name), n_trials=n_trials)
    return ref_study, port_study


@pytest.mark.usefixtures("reference_tpe_draws")
@pytest.mark.parametrize("objective, n_trials", [("branin", 60), ("highdim_mixed", 40)])
def test_study_matches_reference_trial_for_trial(objective, n_trials, port_scores):
    """Branin runs all 60 trials alike. ``highdim_mixed`` parts at trial 27:
    categorical ``c2``'s values 'a' and 'b' have the same below and above
    counts, so their scores are one tie; XLA's sum gives four candidates
    0.06407928 and takes the first ('a'), torch's gives 'b' 0.06407893 and
    'a' 0.06407881 (one float32 ulp) and takes 'b'."""
    ref_study, port_study = _run_both(objective, n_trials)
    parted = assert_same_study(ref_study, port_study, port_scores)
    if parted is None:
        assert port_study.best_value == pytest.approx(ref_study.best_value, rel=1e-4)


def _conditional(trial) -> float:
    """Two co-occurring groups behind a categorical: group mode fits each
    with its own joint KDE."""
    x = trial.suggest_float("x", -2.0, 2.0)
    if trial.suggest_categorical("arm", ["a", "b"]) == "a":
        return x**2 + 0.1 * trial.suggest_int("k", 1, 8)
    return (x - 1.0) ** 2 + math.log10(trial.suggest_float("lr", 1e-4, 1.0, log=True)) ** 2


@pytest.mark.usefixtures("reference_tpe_draws")
def test_multivariate_group_constant_liar_matches_reference(port_scores):
    kwargs = dict(multivariate=True, group=True, constant_liar=True, warn_independent_sampling=False)
    ref_study = optuna_tpu.create_study(sampler=optuna_tpu.samplers.TPESampler(seed=0, **kwargs))
    port_study = optuna_tpu_torch.create_study(sampler=port_tpe.TPESampler(seed=0, device="cpu", **kwargs))
    ref_study.optimize(_conditional, n_trials=30)
    port_study.optimize(_conditional, n_trials=30)
    assert_same_study(ref_study, port_study, port_scores)


@pytest.mark.usefixtures("reference_tpe_draws")
def test_constrained_study_matches_reference(port_scores):
    def constraints(trial):
        return (trial.params["x1"] + trial.params["x2"] - 8.0,)

    ref_study = optuna_tpu.create_study(
        sampler=optuna_tpu.samplers.TPESampler(seed=0, constraints_func=constraints)
    )
    port_study = optuna_tpu_torch.create_study(
        sampler=port_tpe.TPESampler(seed=0, device="cpu", constraints_func=constraints)
    )
    ref_study.optimize(ref_benchmarks.branin, n_trials=30)
    port_study.optimize(port_benchmarks.branin, n_trials=30)
    parted = assert_same_study(ref_study, port_study, port_scores)
    n_same = len(port_study.trials) if parted is None else parted
    got = [t.system_attrs["constraints"][0] for t in port_study.trials[:n_same]]
    want = [t.system_attrs["constraints"][0] for t in ref_study.trials[:n_same]]
    assert [g > 0 for g in got] == [w > 0 for w in want]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert any(t.system_attrs["constraints"][0] > 0 for t in port_study.trials)  # infeasible trials exist


@pytest.mark.usefixtures("reference_tpe_draws")
def test_motpe_study_matches_reference(port_scores):
    def zdt1_small(trial):  # two variables: the reference compiles Branin's programs again
        return port_benchmarks.zdt1(trial, dim=2)

    ref_study = optuna_tpu.create_study(
        directions=["minimize", "minimize"], sampler=optuna_tpu.samplers.TPESampler(seed=0)
    )
    port_study = optuna_tpu_torch.create_study(
        directions=["minimize", "minimize"], sampler=port_tpe.TPESampler(seed=0, device="cpu")
    )
    ref_study.optimize(zdt1_small, n_trials=30)
    port_study.optimize(zdt1_small, n_trials=30)
    assert_same_study(ref_study, port_study, port_scores)


@pytest.mark.usefixtures("reference_tpe_draws")
def test_sample_relative_batch_matches_reference():
    dists = {
        "x": optuna_tpu_torch.distributions.FloatDistribution(-5.0, 10.0),
        "k": optuna_tpu_torch.distributions.IntDistribution(1, 16),
    }
    ref_dists = {
        "x": optuna_tpu.distributions.FloatDistribution(-5.0, 10.0),
        "k": optuna_tpu.distributions.IntDistribution(1, 16),
    }
    rng = np.random.RandomState(2)
    history = [(float(rng.uniform(-5, 10)), int(rng.randint(1, 17))) for _ in range(20)]
    out = []
    for mod, space, sampler in (
        (optuna_tpu, ref_dists, optuna_tpu.samplers.TPESampler(seed=3)),
        (optuna_tpu_torch, dists, port_tpe.TPESampler(seed=3, device="cpu")),
    ):
        study = mod.create_study(sampler=sampler)
        for x, k in history:
            study.add_trial(mod.create_trial(params={"x": x, "k": k}, distributions=space, value=x * x + k))
        out.append(sampler.sample_relative_batch(study, space, 4))
    assert len(out[0]) == len(out[1]) == 4
    for r, p in zip(*out):
        assert r["k"] == p["k"]
        assert abs(r["x"] - p["x"]) <= PARAM_TOL * 15.0


# ------------------------------------------------------------- the port alone


def test_seeded_study_twice_on_the_cpu_is_identical():
    runs = []
    for _ in range(2):
        study = optuna_tpu_torch.create_study(sampler=port_tpe.TPESampler(seed=5, device="cpu"))
        study.optimize(port_benchmarks.highdim_mixed, n_trials=25)
        runs.append([(t.params, t.value) for t in study.trials])
    assert runs[0] == runs[1]


def test_group_decomposed_search_space_matches_reference():
    from optuna_tpu.search_space import _GroupDecomposedSearchSpace as RefGroups
    from optuna_tpu_torch.search_space import _GroupDecomposedSearchSpace as PortGroups

    out = []
    for mod, groups in ((optuna_tpu, RefGroups(True)), (optuna_tpu_torch, PortGroups(True))):
        study = mod.create_study(sampler=mod.samplers.RandomSampler(seed=0))
        study.optimize(_conditional, n_trials=12)
        out.append([sorted(s) for s in groups.calculate(study).search_spaces])
    assert out[0] == out[1] and len(out[0]) >= 2


def test_space_cache_is_capped():
    sampler = port_tpe.TPESampler(seed=0, device="cpu")
    for i in range(port_tpe._SPACE_CACHE_MAX + 2):
        sampler._univariate_space_spec(
            {"x": optuna_tpu_torch.distributions.FloatDistribution(0.0, 1.0 + i)}
        )
    assert len(sampler._univariate_space_specs) <= port_tpe._SPACE_CACHE_MAX


def test_an_ask_uploads_one_packed_buffer(monkeypatch):
    """An ask past the startup trials packs both KDE sets into one upload."""
    from optuna_tpu_torch.samplers._tpe import _kernels

    calls = {"upload": 0}
    real = _kernels.upload_obs

    def counting(*args, **kwargs):
        calls["upload"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(_kernels, "upload_obs", counting)
    study = optuna_tpu_torch.create_study(sampler=port_tpe.TPESampler(seed=0, device="cpu", n_startup_trials=5))
    study.optimize(port_benchmarks.highdim_mixed, n_trials=8)
    assert calls["upload"] == 3  # one per ask past the startup trials
