"""The port's non-fused acquisition maximizer (``optimize_acqf_mixed``)
against the reference's, on the CPU, on a mixed space: a float, a log
float, a stepped int and a three-way categorical.

Both maximize the same LogEI (the reference's fitted state, carried over
by ``convert.acqf_data_from_numpy``) with ``RandomState``s of one seed.
The candidate pool (``space.sample_normalized`` at a seed drawn from the
``RandomState``) and the roulette's picks (``RandomState.choice``) are host
draws: equal bit for bit. The final LogEI value: within 1e-3 (both
ascents start from the same points and climb the same surface).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.gp import acqf as ref_acqf
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.gp import optim_mixed as ref_om
from optuna_tpu.gp.search_space import SearchSpace as RefSpace
from optuna_tpu_torch.gp import optim_mixed as port_om
from optuna_tpu_torch.gp.convert import acqf_data_from_numpy
from optuna_tpu_torch.gp.search_space import SearchSpace as PortSpace
from tests._torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _spaces():
    def dists(mod):
        d = mod.distributions
        return {
            "x": d.FloatDistribution(-2.0, 2.0),
            "lr": d.FloatDistribution(1e-4, 1e-1, log=True),
            "k": d.IntDistribution(0, 20, step=2),
            "c": d.CategoricalDistribution(["a", "b", "c"]),
        }

    return RefSpace(dists(optuna_tpu)), PortSpace(dists(optuna_tpu_torch))


class _Recording(np.random.RandomState):
    """A RandomState that records what the maximizer drew from it."""

    def __init__(self, seed):
        super().__init__(seed)
        self.draws = []

    def randint(self, *args, **kwargs):
        out = super().randint(*args, **kwargs)
        self.draws.append(("randint", np.asarray(out).tolist()))
        return out

    def choice(self, *args, **kwargs):
        out = super().choice(*args, **kwargs)
        self.draws.append(("choice", np.asarray(out).tolist()))
        return out


@pytest.fixture(scope="module")
def problem():
    ref_space, port_space = _spaces()
    rng = np.random.RandomState(0)
    X = ref_space.sample_normalized(20, seed=3).astype(np.float32)
    f = np.sin(3 * X[:, 0]) + X[:, 1] - 0.1 * X[:, 2] + 0.5 * (X[:, 3] == 1) + 0.1 * rng.normal(size=20)
    y = ((f - f.mean()) / f.std()).astype(np.float32)
    is_cat = np.asarray(ref_space.is_categorical)
    state, _, _ = ref_gp.fit_gp(X, y, is_cat, seed=1)
    data = ref_acqf.LogEIData(
        state=state, cat_mask=jnp.asarray(is_cat), best=jnp.asarray(float(y.max()), jnp.float32),
        stabilizing_noise=jnp.asarray(1e-10, jnp.float32),
    )
    return ref_space, port_space, X, data


def test_the_pools_are_equal(problem):
    ref_space, port_space, _, _ = problem
    np.testing.assert_array_equal(port_space.sample_normalized(512, seed=77), ref_space.sample_normalized(512, seed=77))


@pytest.mark.parametrize("seed", [0, 5])
def test_optimize_acqf_mixed_matches_the_reference(problem, seed):
    ref_space, port_space, X, data = problem
    kw = dict(extra_candidates=X[-4:], n_preliminary=256, n_local_search=4)
    ref_rng, port_rng = _Recording(seed), _Recording(seed)
    ref_x, ref_v = ref_om.optimize_acqf_mixed("logei", data, ref_space, ref_rng, **kw)
    x, v = port_om.optimize_acqf_mixed("logei", acqf_data_from_numpy(data, "cpu"), port_space, port_rng, **kw)
    assert port_rng.draws == ref_rng.draws and [k for k, _ in ref_rng.draws] == ["randint", "choice"]
    np.testing.assert_allclose(v, ref_v, rtol=0, atol=1e-3)
    assert np.isfinite(v) and x.shape == ref_x.shape == (4,)
    assert 0.0 <= x[0] <= 1.0 and 0.0 <= x[1] <= 1.0 and x[3] in (0.0, 1.0, 2.0)
    # The stepped int lands on a grid center, as the reference's does.
    np.testing.assert_allclose(port_om.snap_steps(port_space, x), x)
    assert port_space.unnormalize_one(x)["k"] in range(0, 21, 2)


def test_optimize_acqf_sample_matches_the_reference(problem):
    ref_space, port_space, _, data = problem
    ref_x, ref_v = ref_om.optimize_acqf_sample("logei", data, ref_space, np.random.RandomState(2), n_samples=256)
    x, v = port_om.optimize_acqf_sample(
        "logei", acqf_data_from_numpy(data, "cpu"), port_space, np.random.RandomState(2), n_samples=256
    )
    np.testing.assert_array_equal(x, ref_x)
    np.testing.assert_allclose(v, ref_v, rtol=0, atol=1e-4)
