"""The SGPR engine of the port against the reference (``use_pallas=False``),
on the CPU, where the port's Matérn Gram runs its plain version.

Tolerances: the reduced state's ``alpha`` and variance factor ``L`` come out
of four Cholesky factorizations and six triangular solves in f32, on Grams
whose condition reaches ~1e4 here; they are held to rtol 2e-3 of their
largest entry. The ladder rungs and the inducing picks must be equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.gp import sparse as ref_sparse
from optuna_tpu_torch.gp import gp as port_gp
from optuna_tpu_torch.gp import sparse as port_sparse
from tests._torch_port import np64, t32

D, N, M_PAD = 5, 96, 16
REL = 2e-3


def _close(a, b, rel=REL):
    a, b = np64(a), np64(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(1.0, float(np.abs(b).max())))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(11)
    n = 80
    X = np.zeros((N, D), np.float32)
    X[:n] = rng.uniform(0, 1, size=(n, D))
    y = np.zeros(N, np.float32)
    y[:n] = np.cos(4 * X[:n, 0]) + X[:n, 1] - 0.5 * X[:n, 3]
    y[:n] = (y[:n] - y[:n].mean()) / y[:n].std()
    mask = np.zeros(N, np.float32)
    mask[:n] = 1.0
    mask[5] = 2.0  # a collapsed duplicate row carries its count
    cat = np.zeros(D, bool)
    raw = np.r_[rng.normal(0.3, 0.5, D), 0.1, np.log(3e-3)].astype(np.float32)
    return X, y, mask, cat, raw


def test_select_inducing_picks_the_same_rows(problem):
    X, _, mask, _, _ = problem
    idx_r, valid_r = ref_sparse._select_inducing_device(jnp.asarray(X), jnp.asarray(mask), M_PAD)
    idx_p, valid_p = port_sparse._select_inducing_device(t32(X), t32(mask), M_PAD)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_r))


def test_select_inducing_leaves_dead_slots_past_the_history():
    X = np.random.RandomState(0).uniform(size=(32, 3)).astype(np.float32)
    mask = np.zeros(32, np.float32)
    mask[:5] = 1.0
    idx_r, valid_r = ref_sparse._select_inducing_device(jnp.asarray(X), jnp.asarray(mask), 16)
    idx_p, valid_p = port_sparse._select_inducing_device(t32(X), t32(mask), 16)
    assert int(valid_p.sum()) == 5
    np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_r))
    np.testing.assert_array_equal(idx_p.numpy()[:5], np.asarray(idx_r)[:5])


@pytest.fixture(scope="module")
def reduced(problem):
    X, y, mask, cat, raw = problem
    idx, zvalid = ref_sparse._select_inducing_device(jnp.asarray(X), jnp.asarray(mask), M_PAD)
    idx = np.asarray(idx)
    zmask = np.asarray(zvalid).astype(np.float32)
    Z, zy = X[idx], y[idx]
    ref_params = ref_gp.GPParams(jnp.exp(raw[:D]), jnp.exp(raw[D]), jnp.exp(raw[D + 1]) + 1e-5)
    port_params = port_gp.params_from_raw(t32(raw), D, 1e-5)
    ref = ref_sparse.sgpr_reduce(ref_params, Z, zy, zmask, X, y, mask, cat, use_pallas=False)
    port = port_sparse.sgpr_reduce(
        port_params, t32(Z), t32(zy), t32(zmask), t32(X), t32(y), t32(mask), t32(cat, torch.bool)
    )
    return ref, port


def test_sgpr_reduce_matches(reduced):
    (ref_state, ref_Lmm, ref_LB, ref_b, ref_rung), (state, Lmm, L_B, b, rung) = reduced
    assert rung == int(ref_rung)
    _close(state.alpha, ref_state.alpha)
    _close(state.L, ref_state.L)
    _close(Lmm, ref_Lmm)
    _close(L_B, ref_LB)
    _close(b, ref_b)


def test_reduced_posterior_matches(reduced):
    (ref_state, *_), (state, *_) = reduced
    xq = np.random.RandomState(4).uniform(size=(9, D)).astype(np.float32)
    m_r, v_r = ref_gp.posterior(ref_state, xq, np.zeros(D, bool))
    m_p, v_p = port_gp.posterior(state, t32(xq), torch.zeros(D, dtype=torch.bool))
    _close(m_p, m_r)
    _close(v_p, v_r)


def test_sparse_tell_matches(problem, reduced):
    _, _, _, cat, _ = problem
    (ref_state, ref_Lmm, ref_LB, ref_b, _), (state, Lmm, L_B, b, _) = reduced
    x_new = np.full(D, 0.37, np.float32)
    y_new = np.float32(0.8)
    r_state, r_LB, r_b, r_rf = ref_sparse.sparse_tell(
        ref_state, ref_Lmm, ref_LB, ref_b, jnp.asarray(x_new), jnp.asarray(y_new), cat
    )
    p_state, p_LB, p_b, p_rf = port_sparse.sparse_tell(
        state, Lmm, L_B, b, t32(x_new), torch.tensor(y_new), t32(cat, torch.bool)
    )
    assert p_rf == int(r_rf)
    _close(p_LB, r_LB)
    _close(p_b, r_b)
    _close(p_state.alpha, r_state.alpha)


def test_decoupled_gram_matches():
    rng = np.random.RandomState(3)
    K = rng.uniform(size=(8, 8)).astype(np.float32)
    valid = (rng.uniform(size=8) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        port_sparse._decoupled_gram(t32(K), t32(valid), 1.0).numpy(),
        np.asarray(ref_sparse._decoupled_gram(jnp.asarray(K), jnp.asarray(valid), 1.0)),
    )
