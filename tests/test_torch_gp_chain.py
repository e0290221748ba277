"""The speculative chain and the batch ask of the port's GP sampler, on the
CPU.

* ``gp_suggest_chain_fused`` against the reference's program (d = 5,
  n = 40, bucket 64, q = 3), with the reference's own draws handed in a
  round at a time (``fold_in(key, i)``, as ``tests/test_torch_fused.py``
  does): each round's LogEI within 1e-3 on the history that round saw.
* The bucket edge: a chain of q = 8 from n = 60 trials runs at
  ``_bucket(68) = 128`` (the card's edge is n = 1017 … 1024 crossing 1024,
  shrunk here to a 64 crossing), as the reference packs it.
* The reference's queue tests (``tests/test_gp_chain.py``) on the port:
  q sequential asks from one dispatch, a failed trial invalidates the
  queue, snapped discrete dims, a batch of q distinct points, an empty
  batch before startup; and ``precompile_ahead`` is accepted.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import optuna_tpu_torch
from optuna_tpu.gp import fused as ref_fused
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu_torch.gp import fused as port_fused
from optuna_tpu_torch.ops.qmc import sobol_sample
from optuna_tpu_torch.samplers import GPSampler
from tests._torch_port import np64, one_torch_thread, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
from tests.test_torch_fused import (
    D,
    FIT_ITERS,
    LBFGS_ITERS,
    MIN_NOISE,
    N_LOCAL,
    N_POOL,
    _history,
    _jax_draws,
    _port_tail,
    _space_consts,
    _tail,
)

optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
POOL = dict(n_preliminary_samples=128, n_local_search=4, device="cpu")


def _ref_round_histories(X, y, mask, n, raw, xs):
    """The history each of the reference's rounds saw: its earlier winners
    in slots n, n + 1, … with the reference's posterior mean there."""
    import jax.numpy as jnp

    params = ref_gp.GPParams(
        inv_sq_lengthscales=jnp.exp(raw[:D]), scale=jnp.exp(raw[D]), noise=jnp.exp(raw[D + 1]) + MIN_NOISE
    )
    cat = np.zeros(D, bool)
    Xc, yc, mc = X.copy(), y.copy(), mask.copy()
    out = []
    for i, x in enumerate(np.asarray(xs)):
        out.append((Xc.copy(), yc.copy(), mc.copy()))
        state, _ = ref_fused._state_for(params, Xc, yc, cat, mc)
        mean, _ = ref_gp.posterior(state, jnp.asarray(x)[None], cat)
        Xc[n + i], yc[n + i], mc[n + i] = x, float(mean[0]), 1.0
    return out


def test_chain_rounds_match_the_reference():
    """The whole chain once, then each round on the reference's own history
    of that round (its fitted params as the one start, ``fit_iters=0``):
    a round's ascent parts from the reference's by f32 round-off (1e-4 in
    x), and a later round conditioned on a winner 1e-4 away can land 2e-3
    away in LogEI, so each round is held to the history it saw."""
    n, N, q = 40, 64, 3
    X, y, mask, starts, inc = _history(n, N, seed=1)
    pool = sobol_sample(N_POOL, D, seed=0).astype(np.float32)
    c = _space_consts()
    key = jax.random.PRNGKey(7)
    ref_xs, ref_vs, ref_raw, _ = ref_fused.gp_suggest_chain_fused(
        starts, X, y, c["cat_mask"], mask, np.int32(n), pool, inc, key, MIN_NOISE, *_tail(c),
        q=q, n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, fit_iters=FIT_ITERS,
    )
    draws = [_jax_draws(jax.random.fold_in(key, i), len(inc) + N_POOL) for i in range(q)]
    cat = t32(c["cat_mask"], torch.bool)
    kw = dict(n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS)
    xs, vs, raw, stats = port_fused.gp_suggest_chain_fused(
        t32(starts), t32(X), t32(y), cat, t32(mask), n, t32(pool), t32(inc),
        t32(np.stack([d[0] for d in draws])), t32(np.stack([d[1] for d in draws])), MIN_NOISE,
        *_port_tail(c), q=q, fit_iters=FIT_ITERS, **kw,
    )
    assert xs.shape == (q, D) and stats["gp.ladder_rung"] == 0
    assert np.all(np.isfinite(np64(vs))) and np.all((np64(xs) >= 0.0) & (np64(xs) <= 1.0))
    np.testing.assert_allclose(float(vs[0]), float(ref_vs[0]), rtol=0, atol=1e-3)
    # The inputs are left as they were: the slots are written into clones.
    np.testing.assert_array_equal(np64(t32(X)), X)
    for i, (Xi, yi, mi) in enumerate(_ref_round_histories(X, y, mask, n, np.asarray(ref_raw), ref_xs)):
        x_i, v_i, _, _ = port_fused.gp_suggest_chain_fused(
            t32(np.asarray(ref_raw))[None], t32(Xi), t32(yi), cat, t32(mi), n + i, t32(pool), t32(inc),
            t32(draws[i][0])[None], t32(draws[i][1])[None], MIN_NOISE, *_port_tail(c), q=1, fit_iters=0, **kw,
        )
        np.testing.assert_allclose(float(v_i[0]), float(ref_vs[i]), rtol=0, atol=1e-3)


def _seeded(n, sampler):
    from optuna_tpu_torch.distributions import FloatDistribution

    rng = np.random.default_rng(0)
    dists = {"x": FloatDistribution(-2.0, 2.0), "y": FloatDistribution(-2.0, 2.0)}
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.add_trials(
        optuna_tpu_torch.create_trial(params={"x": float(a), "y": float(b)}, distributions=dists, value=float(a * a + b * b))
        for a, b in rng.uniform(-2, 2, size=(n, 2))
    )
    return study, dists


@pytest.mark.parametrize("n,bucket", [(56, 64), (60, 128)])
def test_the_chain_bucket_holds_q_free_slots(monkeypatch, n, bucket):
    seen = []
    real = port_fused.gp_suggest_chain_fused

    def spy(starts, X, y, cat_mask, mask, n_real, *args, **kwargs):
        seen.append((X.shape[0], n_real, int(torch.sum(mask > 0))))
        return real(starts, X, y, cat_mask, mask, n_real, *args, **kwargs)

    monkeypatch.setattr(port_fused, "gp_suggest_chain_fused", spy)
    study, dists = _seeded(n, GPSampler(seed=0, n_startup_trials=5, **POOL))
    out = study.sampler.sample_relative_batch(study, dists, 8)
    assert seen == [(bucket, n, n)] and bucket == ref_gp._bucket(n + 8)
    pts = np.array([[p["x"], p["y"]] for p in out])
    assert pts.shape == (8, 2) and np.all(np.abs(pts) <= 2.0)
    assert len({tuple(p) for p in pts}) == 8


def _sphere(trial):
    x = trial.suggest_float("x", -2.0, 2.0)
    y = trial.suggest_float("y", -2.0, 2.0)
    return x * x + y * y


def test_speculative_chain_serves_from_queue(monkeypatch):
    sampler = GPSampler(seed=3, n_startup_trials=5, speculative_chain=4, **POOL)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    calls = {"n": 0}
    orig = GPSampler._sample_chain

    def counting(self, *a, **k):
        calls["n"] += 1
        return orig(self, *a, **k)

    monkeypatch.setattr(GPSampler, "_sample_chain", counting)
    study.optimize(_sphere, n_trials=13)  # 5 startup + 8 GP asks
    # 8 GP asks at chain depth 4 => exactly 2 chain dispatches.
    assert calls["n"] == 2
    assert len(study.trials) == 13
    assert all(-2.0 <= t.params["x"] <= 2.0 for t in study.trials)


def test_speculative_chain_invalidates_on_failed_trial():
    sampler = GPSampler(seed=4, n_startup_trials=4, speculative_chain=3, **POOL)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(_sphere, n_trials=6)

    # A failed trial leaves n_completed unchanged; the next ask must not pop
    # the stale queue entry meant for a different history length.
    def failing(trial):
        trial.suggest_float("x", -2.0, 2.0)
        raise ValueError("boom")

    study.optimize(failing, n_trials=1, catch=(ValueError,))
    assert sampler._spec_expected_n == 7 and not sampler._spec_queue
    study.optimize(_sphere, n_trials=1)  # 6 completed, not 7: a new chain
    assert sampler._spec_expected_n == 7 and len(sampler._spec_queue) == 2
    study.optimize(_sphere, n_trials=2)
    completed = [t for t in study.trials if t.state.name == "COMPLETE"]
    assert len(completed) == 9


def test_chain_optimizes_sphere():
    sampler = GPSampler(seed=0, n_startup_trials=6, speculative_chain=4, **POOL)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(_sphere, n_trials=30)
    assert study.best_value < 0.35


def test_sample_relative_batch_returns_q_distinct_points():
    space = {
        "x": optuna_tpu_torch.distributions.FloatDistribution(-2.0, 2.0),
        "y": optuna_tpu_torch.distributions.FloatDistribution(-2.0, 2.0),
    }
    sampler = GPSampler(seed=1, n_startup_trials=5, **POOL)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(_sphere, n_trials=6)
    proposals = sampler.sample_relative_batch(study, space, 5)
    assert len(proposals) == 5
    pts = np.array([[p["x"], p["y"]] for p in proposals])
    assert np.all(np.abs(pts) <= 2.0)
    # Fantasized conditioning must push the q proposals apart.
    dists = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    assert np.max(dists) > 1e-3


def test_sample_relative_batch_before_startup_is_empty():
    space = {"x": optuna_tpu_torch.distributions.FloatDistribution(-1.0, 1.0)}
    sampler = GPSampler(seed=1, n_startup_trials=10, **POOL)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    assert sampler.sample_relative_batch(study, space, 3) == [{}, {}, {}]


def test_mixed_space_chain_snaps_discrete():
    def obj(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        k = trial.suggest_int("k", 0, 7)
        c = trial.suggest_categorical("c", ["a", "b", "c"])
        return x + 0.1 * k + (0.0 if c == "a" else 0.5)

    sampler = GPSampler(seed=2, n_startup_trials=5, speculative_chain=3, **POOL)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(obj, n_trials=16)
    for t in study.trials:
        assert isinstance(t.params["k"], int)
        assert t.params["c"] in ("a", "b", "c")


def test_precompile_ahead_is_accepted_and_changes_nothing():
    """Eager PyTorch has no ahead-of-time compile: the knob is kept for the
    reference's signature, and a seeded study is the same either way."""
    runs = []
    for flag in (True, False):
        study = optuna_tpu_torch.create_study(sampler=GPSampler(seed=5, n_startup_trials=4, precompile_ahead=flag, **POOL))
        study.optimize(_sphere, n_trials=6)
        runs.append([t.params for t in study.trials])
    assert runs[0] == runs[1]
