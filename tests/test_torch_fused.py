"""The fused GP programs of the port against the reference, end to end on
the CPU (d = 5; exact at n = 40, sparse at n = 80 with m_pad = 16).

The reference draws its candidate shift and its Gumbel start noise from
``jax.random``; the port takes them as tensors. Each test derives the
reference's own draws from the same key and hands them to the port, so both
programs see the same pool and the same starts (``torch.topk`` could order
exact ties differently from ``lax.top_k``; continuous LogEI values have
none here).

L-BFGS trajectories may part in f32, so the raw iterates are not compared.
What is compared, and the tolerance each gets:

* the fitted loss, both winners scored by the reference's ``_loss``: rtol
  1e-4 (two multi-start fits of the same MAP problem reach the same optimum
  up to f32 line-search round-off; measured 1e-6);
* the LogEI value of the proposal: atol 1e-3 (both ascents start from the
  same candidates and climb the same surface; measured 1e-5);
* the proposal lies in the box [0, 1]^d.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optuna_tpu.gp import fused as ref_fused
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.gp import sparse as ref_sparse
from optuna_tpu_torch.gp import fused as port_fused
from optuna_tpu_torch.gp import sparse as port_sparse
from optuna_tpu_torch.ops.qmc import sobol_sample
from tests._torch_port import np64, t32

D = 5
N_POOL = 256
FIT_ITERS = 30
LBFGS_ITERS = 20
N_LOCAL = 6
MIN_NOISE = 1e-5


def _history(n, N, seed):
    rng = np.random.RandomState(seed)
    X = np.zeros((N, D), np.float32)
    X[:n] = rng.uniform(size=(n, D))
    f = -np.sum((X[:n] - 0.3) ** 2, axis=1) + 0.2 * np.sin(6 * X[:n, 0])
    y = np.zeros(N, np.float32)
    y[:n] = (f - f.mean()) / f.std()
    mask = np.zeros(N, np.float32)
    mask[:n] = 1.0
    default = np.r_[np.zeros(D + 1), np.log(1e-2)].astype(np.float32)
    starts = np.stack([default] + [default + rng.normal(size=D + 2).astype(np.float32) for _ in range(3)])
    return X, y, mask, starts, X[n - 4:n].copy()


def _space_consts():
    return dict(
        cat_mask=np.zeros(D, bool),
        cont_mask=np.ones(D, np.float32),
        lower=np.zeros(D, np.float32),
        upper=np.ones(D, np.float32),
        n_choices=np.zeros(D, np.float32),
        steps=np.zeros(D, np.float32),
        dim_onehot=np.zeros((1, D), np.float32),
        choice_grid=np.zeros((1, 1), np.float32),
        choice_valid=np.zeros((1, 1), bool),
    )


def _jax_draws(key, n_cand):
    k_cand, k_start = jax.random.split(key)
    shift = jax.random.uniform(k_cand, (D,), dtype=jnp.float32)
    gumbel = jax.random.gumbel(k_start, (n_cand,), dtype=jnp.float32)
    return np.asarray(shift), np.asarray(gumbel)


def _tail(c):
    names = ("cont_mask", "lower", "upper", "n_choices", "steps", "dim_onehot", "choice_grid", "choice_valid")
    return [c[k] for k in names]


def _port_tail(c):
    return [t32(a, torch.bool) if a.dtype == bool else t32(a) for a in _tail(c)]


@pytest.fixture(scope="module")
def pool():
    return sobol_sample(N_POOL, D, seed=0).astype(np.float32)


@pytest.fixture(scope="module")
def exact_run(pool):
    n, N = 40, 64
    X, y, mask, starts, inc = _history(n, N, seed=1)
    c = _space_consts()
    key = jax.random.PRNGKey(7)
    ref = ref_fused.gp_suggest_fused(
        starts, X, y, c["cat_mask"], mask, pool, inc, key, MIN_NOISE, *_tail(c),
        n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, fit_iters=FIT_ITERS,
    )
    shift, gumbel = _jax_draws(key, len(inc) + N_POOL)
    port = port_fused.gp_suggest_fused(
        t32(starts), t32(X), t32(y), t32(c["cat_mask"], torch.bool), t32(mask), t32(pool), t32(inc),
        t32(shift), t32(gumbel), MIN_NOISE, *_port_tail(c),
        n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, fit_iters=FIT_ITERS,
    )
    return (X, y, mask, c), ref, port


@pytest.fixture(scope="module")
def sparse_run(pool):
    n, N, m_pad = 80, 128, 16
    X, y, mask, starts, inc = _history(n, N, seed=2)
    c = _space_consts()
    key = jax.random.PRNGKey(9)
    ref = ref_sparse.gp_suggest_sparse_fused(
        starts, X, y, c["cat_mask"], mask, pool, inc, key, MIN_NOISE, *_tail(c),
        q=1, m_pad=m_pad, n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, fit_iters=FIT_ITERS,
    )
    shift, gumbel = _jax_draws(jax.random.fold_in(key, 0), len(inc) + N_POOL)
    port = port_sparse.gp_suggest_sparse_fused(
        t32(starts), t32(X), t32(y), t32(c["cat_mask"], torch.bool), t32(mask), t32(pool), t32(inc),
        t32(shift)[None], t32(gumbel)[None], MIN_NOISE, *_port_tail(c),
        q=1, m_pad=m_pad, n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, fit_iters=FIT_ITERS,
    )
    idx, zvalid = ref_sparse._select_inducing_device(jnp.asarray(X), jnp.asarray(mask), m_pad)
    idx = np.asarray(idx)
    fit_data = (X[idx], y[idx], np.asarray(zvalid).astype(np.float32), c)
    return fit_data, ref, port


def _ref_loss(raw, X, y, mask, c):
    return float(ref_gp._loss(jnp.asarray(np64(raw), jnp.float32), X, y, c["cat_mask"], mask, MIN_NOISE))


@pytest.mark.parametrize("run", ["exact_run", "sparse_run"])
def test_fitted_loss_matches(run, request):
    (X, y, mask, c), ref, port = request.getfixturevalue(run)
    loss_ref = _ref_loss(ref[2], X, y, mask, c)
    loss_port = _ref_loss(port[2], X, y, mask, c)
    assert np.isfinite(loss_port)
    np.testing.assert_allclose(loss_port, loss_ref, rtol=1e-4)


@pytest.mark.parametrize("run", ["exact_run", "sparse_run"])
def test_proposal_logei_matches_and_is_in_bounds(run, request):
    _, ref, port = request.getfixturevalue(run)
    v_ref = float(np.max(np.asarray(ref[1])))
    v_port = float(torch.max(port[1]))
    np.testing.assert_allclose(v_port, v_ref, rtol=0, atol=1e-3)
    x = np64(port[0]).reshape(-1, D)
    assert np.all(np.isfinite(x)) and np.all((x >= 0.0) & (x <= 1.0))


@pytest.mark.parametrize("run", ["exact_run", "sparse_run"])
def test_device_stats_match(run, request):
    _, ref, port = request.getfixturevalue(run)
    ref_stats, port_stats = ref[3], port[3]
    assert int(port_stats["gp.ladder_rung"]) == int(ref_stats["gp.ladder_rung"])
    assert int(port_stats["gp.proposal_fallback_coords"]) == int(ref_stats["gp.proposal_fallback_coords"]) == 0
    assert 1 <= int(port_stats["gp.fit_iterations"]) <= FIT_ITERS
    for k in ("gp.inducing_count", "gp.sparsity_ratio"):
        if k in ref_stats:
            np.testing.assert_allclose(float(port_stats[k]), float(ref_stats[k]))


def test_device_candidates_decode_like_the_reference():
    rng = np.random.RandomState(0)
    base = rng.uniform(size=(64, 4)).astype(np.float32)
    cat = np.array([False, True, False, False])
    n_choices = np.array([0, 3, 0, 0], np.float32)
    steps = np.array([0, 0, 0.25, 0], np.float32)
    key = jax.random.PRNGKey(3)
    ref = ref_fused.device_candidates(base, key, cat, n_choices, steps)
    shift = np.asarray(jax.random.uniform(key, (4,), dtype=jnp.float32))
    port = port_fused.device_candidates(t32(base), t32(shift), t32(cat, torch.bool), t32(n_choices), t32(steps))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_sparse_chain_of_two_tells_the_first_proposal_like_the_reference(pool):
    """q = 2: the second round runs on the state that ``sparse_tell`` raised
    with the first proposal's posterior mean. Same draws per round
    (``fold_in(key, i)``); each round's LogEI within 1e-3."""
    n, N, m_pad, q = 80, 128, 16, 2
    X, y, mask, starts, inc = _history(n, N, seed=2)
    c = _space_consts()
    key = jax.random.PRNGKey(9)
    ref_xs, ref_vs, _, _ = ref_sparse.gp_suggest_sparse_fused(
        starts, X, y, c["cat_mask"], mask, pool, inc, key, MIN_NOISE, *_tail(c),
        q=q, m_pad=m_pad, n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, fit_iters=FIT_ITERS,
    )
    draws = [_jax_draws(jax.random.fold_in(key, i), len(inc) + N_POOL) for i in range(q)]
    xs, vs, _, _ = port_sparse.gp_suggest_sparse_fused(
        t32(starts), t32(X), t32(y), t32(c["cat_mask"], torch.bool), t32(mask), t32(pool), t32(inc),
        t32(np.stack([d[0] for d in draws])), t32(np.stack([d[1] for d in draws])), MIN_NOISE,
        *_port_tail(c),
        q=q, m_pad=m_pad, n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, fit_iters=FIT_ITERS,
    )
    assert xs.shape == (q, D)
    np.testing.assert_allclose(np64(vs), np64(ref_vs), rtol=0, atol=1e-3)
    assert np.all((np64(xs) >= 0.0) & (np64(xs) <= 1.0))
