"""The port's public surface covers the reference's.

Each ported package's ``__all__`` (top level, ``trial``, ``gp``, ``models``,
``samplers``, ``storages``, ``parallel``, and A10's ``terminator``,
``importance``, ``visualization``, ``artifacts``, ``integration``, and
A11's ``telemetry``, ``flight``, ``health``, ``autopilot``, ``slo`` and
``locksan``) holds
every name of the reference's, except the names that open ROADMAP items still own: those are
listed below, each tagged with its item, and each must really be missing
(a name that lands leaves the list). Every exported name resolves. One
``cuda`` test runs the autopilot's ``gp.densify`` on the scan loop's SGPR
chunks on the card.
"""

from __future__ import annotations

import importlib

import pytest

from tests._torch_port import cuda_device  # noqa: F401  (fixture)

#: Reference names the port does not export yet, by package, tagged with the
#: ROADMAP item that owns each.
NOT_YET: dict[str, dict[str, str]] = {
    "": {},
    "trial": {},
    "gp": {},
    "models": {
        # The port has hartmann6_torch / hartmann20_torch instead; the *_jax
        # variants are not queued.
        "branin_jax": "not queued",
        "hartmann6_jax": "not queued",
        "rastrigin_jax": "not queued",
    },
    "samplers": {},
    "terminator": {},
    "importance": {},
    "visualization": {},
    "artifacts": {},
    "integration": {},
    "telemetry": {},
    "flight": {},
    "health": {},
    "autopilot": {},
    "slo": {},
    "locksan": {},
    "storages": {},
    "parallel": {},
}


def _modules(sub: str):
    suffix = f".{sub}" if sub else ""
    return importlib.import_module("optuna_tpu" + suffix), importlib.import_module("optuna_tpu_torch" + suffix)


@pytest.mark.parametrize("sub", sorted(NOT_YET), ids=lambda s: s or "top")
def test_all_covers_the_references_but_for_tagged_items(sub):
    ref, port = _modules(sub)
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == set(NOT_YET[sub])


@pytest.mark.parametrize("sub", sorted(NOT_YET), ids=lambda s: s or "top")
def test_every_exported_name_resolves(sub):
    _, port = _modules(sub)
    for name in port.__all__:
        if sub == "integration":  # forwarded names: each raises, naming the companion package
            with pytest.raises(ImportError, match=f"optuna_tpu_torch.integration.{name} requires"):
                getattr(port, name)
            continue
        assert getattr(port, name) is not None, name


def test_the_repaired_names_import():
    from optuna_tpu_torch import FixedTrial, __version__
    from optuna_tpu_torch.gp import GPParams, GPState, ScaleType, SearchSpace, fit_gp, posterior
    from optuna_tpu_torch.gp.gp import fit_gp as fit_gp_impl
    from optuna_tpu_torch.models import hartmann6
    from optuna_tpu_torch.trial import BaseTrial

    import optuna_tpu

    assert __version__ == optuna_tpu.__version__
    assert fit_gp is fit_gp_impl
    assert all(x is not None for x in (GPParams, GPState, ScaleType, SearchSpace, posterior))
    assert isinstance(FixedTrial({}), BaseTrial)
    point = {f"x{i}": 0.1 * (i + 1) for i in range(6)}
    assert hartmann6(FixedTrial(point)) == optuna_tpu.models.hartmann6(optuna_tpu.trial.FixedTrial(point))


def test_fixed_trial_matches_the_reference():
    import optuna_tpu
    import optuna_tpu_torch

    def objective(trial):
        x = trial.suggest_float("x", -1.0, 1.0)
        n = trial.suggest_int("n", 1, 9, step=2)
        c = trial.suggest_categorical("c", ["a", "b"])
        trial.report(x, 0)
        trial.set_user_attr("u", 1)
        assert not trial.should_prune()
        return x * n + (c == "b")

    params = {"x": 0.5, "n": 7, "c": "b"}
    ref = optuna_tpu.trial.FixedTrial(dict(params), number=3)
    port = optuna_tpu_torch.FixedTrial(dict(params), number=3)
    assert objective(port) == objective(ref)
    assert port.params == ref.params and port.number == ref.number == 3
    assert port.user_attrs == ref.user_attrs
    assert {k: repr(d) for k, d in port.distributions.items()} == {k: repr(d) for k, d in ref.distributions.items()}
    with pytest.raises(ValueError, match="not found"):
        port.suggest_float("missing", 0.0, 1.0)
    with pytest.raises(ValueError, match="out of"):
        optuna_tpu_torch.FixedTrial({"x": 5.0}).suggest_float("x", 0.0, 1.0)


@pytest.mark.cuda
def test_the_autopilot_densifies_the_scan_loops_sgpr_on_the_card(cuda_device, monkeypatch):
    """Phase 34's sequence at a small size on the card (Hartmann-6, 8 startup
    trials, chunks of 8 past ``n_exact_max=12``, ``n_inducing=16``): the
    first SGPR sync decides ``gp.densify``, K1's inducing operand is 16 rows
    in chunks 0-1 and 32 in chunks 2-3, the verdict at chunk 2's sync sets
    chunk 4's width, and K1's launch counter counts every call."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch import autopilot, telemetry
    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.gp import sparse
    from optuna_tpu_torch.models.benchmarks import hartmann6_torch
    from optuna_tpu_torch.ops.kernels import matern
    from optuna_tpu_torch.parallel import VectorizedObjective, scan_loop

    calls, chunk = [], {"idx": -1}
    real_draws, real_gram = scan_loop._chunk_draws, sparse.matern52_gram

    def draws(key_seed, chunk_idx, *a, **k):
        chunk["idx"] = chunk_idx
        return real_draws(key_seed, chunk_idx, *a, **k)

    def gram(x1, *a, **k):
        assert x1.is_cuda
        calls.append((chunk["idx"], int(x1.shape[0])))
        return real_gram(x1, *a, **k)

    monkeypatch.setattr(scan_loop, "_chunk_draws", draws)
    monkeypatch.setattr(sparse, "matern52_gram", gram)
    registry = telemetry.get_registry()
    telemetry.enable(telemetry.MetricsRegistry())
    try:
        study = ot.create_study(sampler=ot.samplers.RandomSampler(seed=0))
        autopilot.attach(study, config=autopilot.AutopilotPolicy(
            mode="act", interval_s=0.0, overrides={"sparse_heldout_err_warn": 0.0}, rollback_after=16,
            cooldown_s=3600.0))
        objective = VectorizedObjective(hartmann6_torch, {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(6)})
        before = matern.LAUNCHES
        study.optimize_scan(objective, 48, sync_every=8, n_startup_trials=8, seed=0, n_exact_max=12, n_inducing=16)
        launches = matern.LAUNCHES - before
    finally:
        telemetry.enable(registry)
        telemetry.disable()
    (record,) = [r for r in study.__dict__["_autopilot"].report()["actions"] if r["action"] == "gp.densify"]
    assert record["state"] in ("held", "rolled_back")
    last = 32 if record["state"] == "held" else 16
    rows = {c: sorted({m for k, m in calls if k == c}) for c, _ in calls}
    assert rows == {0: [16], 1: [16], 2: [32], 3: [32], 4: [last]}
    assert launches == len(calls) and study._scan_gp_control["n_inducing"] == last
    assert all(t.state == ot.TrialState.COMPLETE for t in study.trials)
