"""CMA-ES of the port (``optuna_tpu_torch/ops/cmaes.py`` and
``samplers/_cmaes.py``) against the reference, on the CPU. Mirrors
``tests/test_cmaes.py`` and ``tests/test_cmaes_features.py``.

* ``cma_init`` is host NumPy in both: every field equal bit for bit.
* ``cma_tell`` and ``cma_tell_and_ask`` given the same state, population,
  fitness and draws: every state field within ``RTOL`` (float32 sums and
  ``eigh`` in another framework), with ``lr_adapt`` on and off and with
  ``sep``. The port canonicalizes the sign of each eigenvector (largest
  entry positive); the ask is held to the reference's arithmetic on the
  reference's own eigenbasis canonicalized the same way.
* ``apply_margin`` and ``should_stop`` are host NumPy: equal results on
  states crafted to trip each criterion.
* The sampler with the reference's draws handed in
  (``tests/_torch_port.py::reference_cma_draws``): the startup trial and
  the whole first generation trial for trial (C = I, so no eigenbasis
  enters). Later generations sample through each side's eigenbasis, so
  studies are held to end state: counts, generations, restart counters and
  the best value within ``BEST_FACTOR`` of the reference's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.ops import cmaes as ref_cma
from optuna_tpu_torch.ops import cmaes as port_cma
from optuna_tpu_torch.samplers import CmaEsSampler
from tests._torch_port import jax_cma_draws, reference_cma_draws  # noqa: F401

RTOL, ATOL = 2e-5, 2e-6  # float32 state updates, eigh and sums in another framework
# An ask through an evolved eigenbasis: eigenvectors of close eigenvalues
# move by ~eps / gap between two LAPACKs (7.2e-6 seen at d = 10).
ASK_ATOL = 1e-4
BEST_FACTOR = 10.0  # best value of a study against the reference's
CPU = "cpu"

optuna_tpu.logging.set_verbosity(optuna_tpu.logging.ERROR)
optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.ERROR)


def _port_state(ref_state) -> port_cma.CmaState:
    fields = {f: torch.as_tensor(np.array(getattr(ref_state, f))) for f in port_cma._TENSOR_FIELDS}
    return port_cma.CmaState(sep=bool(ref_state.sep), **fields)


def assert_states_close(port_state, ref_state, rtol=RTOL, atol=ATOL) -> None:
    host = port_cma.to_host(port_state)[0]
    assert host.sep == bool(ref_state.sep)
    for f in port_cma._TENSOR_FIELDS:
        got, want = np.asarray(getattr(host, f)), np.asarray(getattr(ref_state, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=f)


def _evolved(d: int, popsize: int, sep: bool, lr_adapt: bool, gens: int = 4, seed: int = 0):
    """A reference state after a few tells on a sphere: C is no longer I."""
    rng = np.random.RandomState(seed)
    state = ref_cma.cma_init(rng.uniform(0.3, 0.7, size=d), 0.3, popsize=popsize, sep=sep)
    for _ in range(gens):
        X = np.clip(rng.normal(0.5, 0.2, size=(popsize, d)), 0, 1).astype(np.float32)
        fitness = np.sum((X - 0.3) ** 2, axis=1).astype(np.float32)
        state = ref_cma.cma_tell(state, X, fitness, lr_adapt=lr_adapt)
    return state, rng


def _canonical(B: np.ndarray) -> np.ndarray:
    pivot = np.argmax(np.abs(B), axis=0)
    signs = np.sign(B[pivot, np.arange(B.shape[1])])
    return B * np.where(signs == 0, 1.0, signs)


def _reference_ask_canonical(ref_state, z: np.ndarray) -> np.ndarray:
    """The reference's ask arithmetic on its own eigenbasis, canonicalized."""
    if bool(ref_state.sep):
        B = np.eye(len(ref_state.mean), dtype=np.float32)
        D = np.sqrt(np.clip(np.diagonal(np.asarray(ref_state.C)), 1e-20, None))
    else:
        w, B = jnp.linalg.eigh(ref_state.C)
        B, D = _canonical(np.asarray(B)), np.sqrt(np.clip(np.asarray(w), 1e-20, None))
    y = (z * D[None, :]) @ B.T
    return np.clip(np.asarray(ref_state.mean)[None, :] + float(ref_state.sigma) * y, 0.0, 1.0)


@pytest.mark.parametrize("d,popsize,sep", [(3, None, False), (10, 12, False), (7, 8, True), (1, None, False)])
def test_cma_init_equals_the_reference_bit_for_bit(d, popsize, sep):
    mean0 = np.linspace(0.2, 0.8, d)
    port = port_cma.cma_init(mean0, 0.25, popsize=popsize, sep=sep, device=CPU)
    ref = ref_cma.cma_init(mean0, 0.25, popsize=popsize, sep=sep)
    assert_states_close(port, ref, rtol=0, atol=0)
    assert port_cma.default_popsize(d) == ref_cma.default_popsize(d)


@pytest.mark.parametrize("d,n", [(4, 8), (10, 12)])
def test_first_ask_equals_the_reference_with_its_draws(d, n):
    state_ref = ref_cma.cma_init(np.full(d, 0.4), 0.3, popsize=n)
    key = jax.random.fold_in(jax.random.PRNGKey(11), 0)
    want = np.asarray(ref_cma.cma_ask(state_ref, key, n))
    got = port_cma.cma_ask(port_cma.cma_init(np.full(d, 0.4), 0.3, popsize=n, device=CPU), jax_cma_draws(11, 0, n, d, CPU))
    np.testing.assert_array_equal(got.numpy(), want)  # C = I: the same float32 operations, one FMA


@pytest.mark.parametrize("lr_adapt", [False, True])
@pytest.mark.parametrize("sep", [False, True])
@pytest.mark.parametrize("d,popsize", [(5, 8), (10, 16)])
def test_tell_and_tell_and_ask_equal_the_reference(d, popsize, sep, lr_adapt):
    ref_state, rng = _evolved(d, popsize, sep, lr_adapt)
    X = np.clip(rng.normal(0.5, 0.2, size=(popsize, d)), 0, 1).astype(np.float32)
    fitness = np.sum((X - 0.3) ** 2, axis=1).astype(np.float32)
    fitness[1] = fitness[0]  # a tie: the stable order keeps trial order
    want = ref_cma.cma_tell(ref_state, X, fitness, lr_adapt=lr_adapt)
    got = port_cma.cma_tell(_port_state(ref_state), torch.as_tensor(X), torch.as_tensor(fitness), lr_adapt=lr_adapt)
    assert_states_close(got, want)
    if not lr_adapt:
        assert float(port_cma.to_host(got)[0].eta_m) == 1.0

    z = jax_cma_draws(5, 9, popsize, d, CPU)
    fused, queue = port_cma.cma_tell_and_ask(
        _port_state(ref_state), torch.as_tensor(X), torch.as_tensor(fitness), z, lr_adapt=lr_adapt
    )
    assert_states_close(fused, want)
    np.testing.assert_allclose(queue.numpy(), _reference_ask_canonical(want, z.numpy()), rtol=0, atol=ASK_ATOL)
    # The reference's own queue is the same distribution: equal up to the
    # eigenvector signs, so its spread about the mean matches.
    ref_fused, ref_queue = ref_cma.cma_tell_and_ask(
        ref_state, X, fitness, jax.random.fold_in(jax.random.PRNGKey(5), 9), popsize, lr_adapt=lr_adapt
    )
    mean, ref_queue = np.asarray(ref_fused.mean), np.asarray(ref_queue)
    inside = np.all((ref_queue > 0) & (ref_queue < 1) & (queue.numpy() > 0) & (queue.numpy() < 1), axis=1)
    np.testing.assert_allclose(
        np.linalg.norm(queue.numpy() - mean, axis=1)[inside], np.linalg.norm(ref_queue - mean, axis=1)[inside],
        rtol=1e-4, atol=1e-6,
    )


def test_eigenvectors_are_canonical_and_the_draws_are_seeded():
    ref_state, _ = _evolved(6, 8, False, False)
    B, D = port_cma._eig_decomp(_port_state(ref_state))
    B = B.numpy()
    assert np.all(B[np.argmax(np.abs(B), axis=0), np.arange(6)] > 0)
    np.testing.assert_allclose(B @ np.diag(D.numpy() ** 2) @ B.T, np.asarray(ref_state.C), rtol=1e-4, atol=1e-6)
    a = port_cma.ask_draws(3, (1 << 16) ^ 5, 8, 6, CPU)
    assert torch.equal(a, port_cma.ask_draws(3, (1 << 16) ^ 5, 8, 6, CPU))
    assert not torch.equal(a, port_cma.ask_draws(3, 5, 8, 6, CPU))


def test_state_round_trip_and_one_packed_read():
    state = port_cma.cma_init(np.full(3, 0.5), 0.3, popsize=8, device=CPU)
    queue = np.random.RandomState(0).uniform(size=(8, 3))
    blob = port_cma.state_to_bytes(state, extra={"queue": queue})
    state2, extra = port_cma.state_from_bytes(blob, device=CPU)
    assert_states_close(state2, ref_cma.cma_init(np.full(3, 0.5), 0.3, popsize=8), rtol=0, atol=0)
    np.testing.assert_array_equal(extra["queue"], queue)
    host, (q,) = port_cma.to_host(state2, torch.ones(8, 3))
    assert host.generation.dtype == np.int32 and q.shape == (8, 3)


# ------------------------------------------------------------------- margin


def test_apply_margin_equals_the_reference():
    ref_state = ref_cma.cma_init(np.array([0.52, 0.5, 0.13]), 0.3, popsize=6)
    C = np.asarray(ref_state.C).copy()
    C[0, 0], C[2, 2] = 1e-12, 1e-3
    ref_state = ref_state._replace(C=jnp.asarray(C, dtype=jnp.float32))
    steps = np.array([0.25, 0.0, 0.1])
    want = ref_cma.apply_margin(ref_state, steps, alpha=0.05)
    got = port_cma.apply_margin(_port_state(ref_state), steps, alpha=0.05)
    assert_states_close(got, want, rtol=0, atol=0)
    # Enough variance already: unchanged.
    healthy = port_cma.cma_init(np.array([0.5, 0.5]), 0.3, popsize=6, device=CPU)
    assert port_cma.apply_margin(healthy, np.array([0.25, 0.0]), alpha=0.05) is healthy


# -------------------------------------------------------------- termination


def _stop_cases():
    base = ref_cma.cma_init(np.full(3, 0.5), 0.3, popsize=6)
    cases = {
        "tolfun": (base, np.zeros(6), np.zeros(12)),
        "tolx": (base._replace(sigma=base.sigma * 0.0 + 1e-20), np.arange(6.0), np.arange(5.0)),
        "tolxup": (base._replace(sigma=base.sigma * 0.0 + 1e5), np.arange(6.0), np.arange(5.0)),
        # The reference's conditioncov test reads np.min(eigvals, initial=0.0),
        # which is never above 0: the criterion never trips, in either package.
        "conditioncov": (base._replace(C=jnp.diag(jnp.asarray([1.0, 1e-15, 1.0], jnp.float32))), np.arange(6.0),
                         np.arange(5.0)),
        "noeffectcoord": (base._replace(mean=jnp.full(3, 1e13, jnp.float32), sigma=base.sigma * 0 + 1e-3),
                          np.arange(6.0), np.arange(5.0)),
        "stagnation": (base, np.arange(6.0), np.zeros(260)),
        "healthy": (base, np.arange(6.0), np.arange(5.0)),
    }
    d = 3
    axis_state = base._replace(
        mean=jnp.asarray([1e13, 0.5, 0.5], jnp.float32), C=jnp.diag(jnp.asarray([1.0, 1e6, 1e6], jnp.float32)),
        sigma=base.sigma * 0 + 1e-3, generation=jnp.asarray(0 % d, jnp.int32),
    )
    cases["noeffectaxis"] = (axis_state, np.arange(6.0), np.arange(5.0))
    cases["sep"] = (ref_cma.cma_init(np.full(3, 0.5), 0.3, popsize=6, sep=True), np.arange(6.0), np.arange(5.0))
    return cases


@pytest.mark.parametrize("case", sorted(_stop_cases()))
def test_should_stop_equals_the_reference(case):
    state, fitness, hist = _stop_cases()[case]
    want = ref_cma.should_stop(state, fitness, hist, 0.3)
    assert port_cma.should_stop(_port_state(state), fitness, hist, 0.3) == want
    expected = {"healthy": None, "sep": None, "conditioncov": None}
    assert want == expected.get(case, case)


# ------------------------------------------------------------------ sampler


def _sphere(dim: int):
    def objective(trial):
        return sum((trial.suggest_float(f"x{i}", -5.0, 5.0) - 1.0) ** 2 for i in range(dim))

    return objective


def _rastrigin(dim: int):
    def objective(trial):
        xs = np.array([trial.suggest_float(f"x{i}", -5.12, 5.12) for i in range(dim)])
        return float(10 * dim + np.sum(xs * xs - 10 * np.cos(2 * np.pi * xs)))

    return objective


def _run(pkg, objective, n_trials, direction="minimize", **kwargs):
    if pkg is optuna_tpu_torch:
        kwargs["device"] = CPU
    sampler = pkg.samplers.CmaEsSampler(warn_independent_sampling=False, **kwargs)
    study = pkg.create_study(direction=direction, sampler=sampler)
    study.optimize(objective, n_trials=n_trials)
    return study, sampler


def _params(study):
    return [(t.number, t.params, t.system_attrs.get("cma:generation")) for t in study.trials]


@pytest.mark.usefixtures("reference_cma_draws")
@pytest.mark.parametrize("kwargs", [dict(seed=0, popsize=8), dict(seed=4, x0={"x0": 1.0, "x1": -2.0, "x2": 0.0,
                                                                                   "x3": 2.5}, sigma0=0.2)])
def test_first_generation_is_trial_for_trial_the_reference(kwargs):
    ref, _ = _run(optuna_tpu, _sphere(4), 12, **kwargs)
    port, _ = _run(optuna_tpu_torch, _sphere(4), 12, **kwargs)
    popsize = kwargs.get("popsize") or port_cma.default_popsize(4)
    first = 1 + popsize  # the startup trial, then generation 0 from the queue
    assert _params(port)[:first] == _params(ref)[:first]
    assert [t.values for t in port.trials[:first]] == [t.values for t in ref.trials[:first]]


@pytest.mark.usefixtures("reference_cma_draws")
@pytest.mark.parametrize(
    "objective,dim,n_trials,kwargs",
    [
        ("sphere", 10, 240, dict(seed=1)),
        ("rastrigin", 10, 240, dict(seed=0, popsize=16)),
        ("sphere", 10, 160, dict(seed=2, use_separable_cma=True)),
        ("rastrigin", 10, 160, dict(seed=3, lr_adapt=True)),
    ],
)
def test_studies_hold_the_reference_end_state(objective, dim, n_trials, kwargs):
    fn = {"sphere": _sphere, "rastrigin": _rastrigin}[objective](dim)
    ref, ref_sampler = _run(optuna_tpu, fn, n_trials, **kwargs)
    port, port_sampler = _run(optuna_tpu_torch, fn, n_trials, **kwargs)
    assert [t.state for t in port.trials] == [optuna_tpu_torch.TrialState.COMPLETE] * n_trials
    ref_state, ref_extra = ref_sampler._restore_state(ref)
    port_state, port_extra = port_sampler._restore_state(port)
    assert int(port_cma.to_host(port_state)[0].generation) == int(ref_state.generation)
    assert int(port_extra["generation"]) == int(ref_state.generation)
    assert int(port_extra["evals_run"]) == int(ref_extra["evals_run"])
    assert port.best_value <= BEST_FACTOR * ref.best_value + 1e-3
    assert port.best_value < port.trials[0].value  # it optimizes


@pytest.mark.usefixtures("reference_cma_draws")
@pytest.mark.parametrize("strategy,n_trials", [("ipop", 60), ("bipop", 160)])
def test_restarts_hold_the_reference_counters(strategy, n_trials):
    """A constant objective trips tolfun on both sides at the same
    generation; IPOP doubles the popsize, BIPOP draws its regimes from the
    same host generator."""
    def flat(t):
        return (t.suggest_float("a", 0, 1), t.suggest_float("b", 0, 1)) and 7.0

    kwargs = dict(seed=1, popsize=4, restart_strategy=strategy, inc_popsize=2)
    ref, ref_sampler = _run(optuna_tpu, flat, n_trials, **kwargs)
    port, port_sampler = _run(optuna_tpu_torch, flat, n_trials, **kwargs)
    ref_extra, port_extra = ref_sampler._restore_state(ref)[1], port_sampler._restore_state(port)[1]
    for key in ("n_restarts", "popsize", "run", "n_large", "budget_large", "budget_small", "regime", "evals_run"):
        assert int(port_extra[key]) == int(ref_extra[key]), key
    assert int(port_extra["n_restarts"]) >= 1
    assert [t.system_attrs.get("cma:run", 0) for t in port.trials] == [
        t.system_attrs.get("cma:run", 0) for t in ref.trials
    ]


def test_ipop_restart_still_optimizes_and_margin_keeps_int_dims_alive():
    study, _ = _run(optuna_tpu_torch, _rastrigin(3), 90, seed=3, popsize=6, restart_strategy="ipop")
    assert study.best_value < 30.0

    def objective(trial):
        k = trial.suggest_int("k", 0, 10)
        j = trial.suggest_int("j", 0, 10)
        return float((k - 3) ** 2 + (j - 7) ** 2)

    study, _ = _run(optuna_tpu_torch, objective, 80, seed=4, popsize=6, with_margin=True)
    assert study.best_value <= 2.0
    assert len({(t.params["k"], t.params["j"]) for t in study.trials[-18:]}) > 1


def test_lr_adapt_reduces_eta_under_noise():
    rng = np.random.RandomState(0)
    state = port_cma.cma_init(np.full(4, 0.5), 0.3, popsize=8, device=CPU)
    for _ in range(25):
        X = np.clip(rng.normal(0.5, 0.3, size=(8, 4)), 0, 1).astype(np.float32)
        state = port_cma.cma_tell(state, torch.as_tensor(X), torch.as_tensor(rng.normal(size=8).astype(np.float32)),
                                  lr_adapt=True)
    host = port_cma.to_host(state)[0]
    assert float(host.eta_m) < 1.0 and float(host.eta_c) < 1.0


def test_dimension_change_restarts_the_optimizer():
    """When the intersection space shrinks, the stored optimizer no longer
    matches and a new one starts. The reference then tells the new optimizer
    the old one's generation-0 trials and raises on their shapes; the port
    tells it only trials of its own dimension."""
    def objective(trial):
        n = 3 if trial.number < 12 else 2  # the intersection space shrinks
        return sum(trial.suggest_float(f"x{i}", -1, 1) ** 2 for i in range(n))

    with pytest.raises(TypeError, match="incompatible shapes"):
        _run(optuna_tpu, objective, 30, seed=0, popsize=4)
    study, sampler = _run(optuna_tpu_torch, objective, 30, seed=0, popsize=4)
    state, extra = sampler._restore_state(study)
    assert tuple(state.mean.shape) == (2,) and extra["queue"].shape == (4, 2)
    assert int(extra["generation"]) >= 3  # the new optimizer went on telling
    assert all(t.state == optuna_tpu_torch.TrialState.COMPLETE for t in study.trials)


def test_storage_resume_maximize_and_rejections():
    storage = optuna_tpu_torch.storages.InMemoryStorage()
    s1 = optuna_tpu_torch.create_study(study_name="cma", storage=storage, sampler=CmaEsSampler(seed=3, device=CPU))
    s1.optimize(_sphere(4), n_trials=30)
    s2 = optuna_tpu_torch.create_study(
        study_name="cma", storage=storage, sampler=CmaEsSampler(seed=3, device=CPU), load_if_exists=True
    )
    s2.optimize(_sphere(4), n_trials=30)
    assert len(s2.trials) == 60
    assert any(k.startswith("cma:state") for k in storage.get_study_system_attrs(s2._study_id))

    study, _ = _run(optuna_tpu_torch, lambda t: -(t.suggest_float("a", -3, 3) - 0.5) ** 2 - t.suggest_float("b", 0, 1),
                    80, direction="maximize", seed=2)
    assert study.best_value > -0.2

    multi = optuna_tpu_torch.create_study(directions=["minimize"] * 2, sampler=CmaEsSampler(seed=5, device=CPU))
    with pytest.raises(ValueError):
        multi.optimize(lambda t: (t.suggest_float("x", 0, 1), t.suggest_float("y", 0, 1)), n_trials=2)
    with pytest.raises(ValueError, match="restart_strategy"):
        CmaEsSampler(restart_strategy="lipop")


def test_seeded_study_twice_on_the_cpu_is_identical():
    a, _ = _run(optuna_tpu_torch, _rastrigin(5), 60, seed=7)
    b, _ = _run(optuna_tpu_torch, _rastrigin(5), 60, seed=7)
    assert _params(a) == _params(b)


def test_default_device_is_the_card():
    sampler = CmaEsSampler(seed=0)
    if torch.cuda.is_available():
        assert sampler.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            sampler.device  # noqa: B018
