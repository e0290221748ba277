"""The port's host GP fit (``fit_gp``, ``select_inducing_host``,
``fit_gp_sparse``) against the reference's, on the CPU (d = 3, n = 24 exact,
n = 80 sparse with 16 inducing points).

Both packages get the same inputs from a NumPy seed. The targets carry
observation noise (sd 0.1 of a unit-scale function), so the MAP optimum is
interior: with noise-free targets the fitted noise sits on its floor,
where the loss is flat in the log-noise and no fit pins that coordinate.
Tolerances:

* raw log-params within 1e-3 absolute and the MLL loss (the reference's
  ``_loss`` at each side's winner) within 1e-4 relative: two batched
  L-BFGS fits of one MAP problem from the same starts reach the same
  optimum up to f32 round-off;
* the inducing picks are host NumPy on both sides: equal;
* the posterior mean and variance of the fitted (reduced) state at 32 query
  points within 1e-3 absolute (for the sparse fit, whose raw noise
  coordinate parts by up to 2e-3 in a near-flat direction, this is the
  comparison).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.gp import sparse as ref_sparse
from optuna_tpu_torch.gp import gp as port_gp
from optuna_tpu_torch.gp import sparse as port_sparse
from tests._torch_port import np64, one_torch_thread, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D = 3
CPU = "cpu"
MIN_NOISE = 1e-5


def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.uniform(size=(n, D)).astype(np.float32)
    f = np.sin(3 * X[:, 0]) + (X[:, 1] - 0.4) ** 2 - 0.5 * X[:, 2] + 0.1 * rng.normal(size=n)
    y = ((f - f.mean()) / f.std()).astype(np.float32)
    return X, y


def _ref_loss(raw, X, y, mask):
    N = ref_gp._bucket(len(X))
    Xp = np.zeros((N, D), np.float32)
    Xp[: len(X)] = X
    yp = np.zeros(N, np.float32)
    yp[: len(y)] = y
    mp = np.zeros(N, np.float32)
    mp[: len(mask)] = mask
    return float(ref_gp._loss(jnp.asarray(np64(raw), jnp.float32), Xp, yp, np.zeros(D, bool), mp, MIN_NOISE))


CASES = {
    "plain": dict(),
    "counts": dict(counts=np.r_[np.ones(20), [2.0, 3.0, 1.0, 4.0]].astype(np.float32)),
    "warm": dict(warm_start_raw=np.r_[np.full(D, 0.3), 0.1, np.log(1e-3)].astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_gp_matches_the_reference(case):
    X, y = _data(24, seed=1)
    kw = CASES[case]
    is_cat = np.zeros(D, bool)
    ref_state, ref_raw, _ = ref_gp.fit_gp(X, y, is_cat, seed=5, **kw)
    state, raw, stats = port_gp.fit_gp(X, y, is_cat, seed=5, device=CPU, **kw)
    assert stats["gp.ladder_rung"] == 0
    np.testing.assert_allclose(raw, np.asarray(ref_raw), rtol=0, atol=1e-3)
    mask = kw.get("counts", np.ones(len(X), np.float32))
    np.testing.assert_allclose(_ref_loss(raw, X, y, mask), _ref_loss(ref_raw, X, y, mask), rtol=1e-4)
    q = np.random.RandomState(2).uniform(size=(32, D)).astype(np.float32)
    mean, var = port_gp.posterior(state, t32(q), t32(is_cat, bool))
    ref_mean, ref_var = ref_gp.posterior(ref_state, jnp.asarray(q), jnp.asarray(is_cat))
    np.testing.assert_allclose(np64(mean), np64(ref_mean), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np64(var), np64(ref_var), rtol=0, atol=1e-3)


@pytest.mark.parametrize("n,m", [(80, 16), (200, 33), (5, 9)])
def test_select_inducing_host_picks_like_the_reference(n, m):
    X = np.random.RandomState(n).uniform(size=(n, 4)).astype(np.float32)
    np.testing.assert_array_equal(port_sparse.select_inducing_host(X, m), ref_sparse.select_inducing_host(X, m))


@pytest.mark.parametrize("n", [80, 12])
def test_fit_gp_sparse_posterior_matches_the_reference(n):
    """n = 80 above ``n_exact_max=64`` takes the SGPR fit (K1's plain
    version on the CPU); n = 12 with 16 inducing points is the ``m >= n``
    fall-back to the exact fit."""
    X, y = _data(n, seed=3)
    is_cat = np.zeros(D, bool)
    kw = dict(seed=4, n_exact_max=64 if n > 64 else 8, n_inducing=16)
    ref_state, ref_raw, ref_stats = ref_gp.fit_gp(X, y, is_cat, **kw)
    state, raw, stats = port_gp.fit_gp(X, y, is_cat, device=CPU, **kw)
    assert state.X.shape == tuple(ref_state.X.shape)
    if n > 64:
        assert stats["gp.inducing_count"] == int(ref_stats["gp.inducing_count"]) == 16
        np.testing.assert_allclose(stats["gp.sparsity_ratio"], float(ref_stats["gp.sparsity_ratio"]))
    else:
        assert "gp.inducing_count" not in stats and "gp.inducing_count" not in ref_stats
    q = np.random.RandomState(6).uniform(size=(32, D)).astype(np.float32)
    mean, var = port_gp.posterior(state, t32(q), t32(is_cat, bool))
    ref_mean, ref_var = ref_gp.posterior(ref_state, jnp.asarray(q), jnp.asarray(is_cat))
    np.testing.assert_allclose(np64(mean), np64(ref_mean), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np64(var), np64(ref_var), rtol=0, atol=1e-3)


def test_fit_gp_sparse_fall_back_is_the_exact_fit():
    X, y = _data(12, seed=3)
    is_cat = np.zeros(D, bool)
    via_sparse = port_sparse.fit_gp_sparse(X, y, is_cat, seed=4, n_inducing=16, device=CPU)
    exact = port_gp.fit_gp(X, y, is_cat, seed=4, device=CPU)
    np.testing.assert_array_equal(via_sparse[1], exact[1])
    assert via_sparse[0].X.shape == exact[0].X.shape == (16, D)


@pytest.mark.parametrize("knobs", [(None, None), (64, 16), (500, 200)])
def test_autopilot_densify_turns_the_knobs_as_the_reference(knobs):
    """Each call doubles the inducing capacity up to the cap (256), then
    raises the exact threshold out of reach; each undo restores the knobs
    it found. Five calls and their undos, in reverse, on both samplers."""
    from optuna_tpu.samplers import GPSampler as RefGPSampler
    from optuna_tpu_torch.samplers import GPSampler

    n_exact_max, n_inducing = knobs
    ref = RefGPSampler(seed=0, n_exact_max=n_exact_max, n_inducing=n_inducing)
    port = GPSampler(seed=0, n_exact_max=n_exact_max, n_inducing=n_inducing, device=CPU)
    undos, seen = [], []
    for _ in range(5):
        undos.append((ref.autopilot_densify(), port.autopilot_densify()))
        assert port._sparse_limits() == ref._sparse_limits()
        seen.append(port._sparse_limits())
    for ref_undo, port_undo in reversed(undos):
        ref_undo()
        port_undo()
        assert port._sparse_limits() == ref._sparse_limits()
    assert (port._n_exact_max, port._n_inducing) == knobs
    assert seen[-1][0] == 10**9 and seen[-2][1] == 256
