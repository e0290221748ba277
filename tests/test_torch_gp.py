"""GP core of the port against the reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Tolerances:

* kernel values: atol 5e-7 (values ≤ scale ≈ 1; f32 sums of 5 terms in two
  orders);
* MLL loss: rtol 2e-5, gradients rtol 2e-3 / atol 2e-3 (f32 Cholesky of a
  32×32 Gram in two LAPACK call orders; the gradient goes through the
  factor's backward, which amplifies round-off by the Gram's condition);
* posterior mean/variance: atol 2e-5; LogEI: atol 2e-5 plus rtol 1e-5 (the
  far tail reaches -30, where f32 keeps ~6 digits); LogEI gradients rtol
  1e-3 / atol 1e-4 (one triangular solve against the same factor, then
  log_h's derivative);
* L-BFGS-B: same iteration count, x within 1e-4 (the issue's contract).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optuna_tpu.distributions import FloatDistribution
from optuna_tpu.gp import acqf as ref_acqf
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.ops.lbfgsb import lbfgsb as ref_lbfgsb
from optuna_tpu.ops.special import log_h as ref_log_h
from optuna_tpu.samplers import _resilience as ref_res
from optuna_tpu.testing.fault_injection import PATHOLOGICAL_HISTORY_PLANS
from optuna_tpu_torch.gp import convert
from optuna_tpu_torch.gp import gp as port_gp
from optuna_tpu_torch.gp.acqf import LogEIData, logei_value
from optuna_tpu_torch.ops.lbfgsb import lbfgsb as port_lbfgsb
from optuna_tpu_torch.ops.special import log_h as port_log_h
from optuna_tpu_torch.samplers import _resilience as port_res
from tests._torch_port import np64, t32

N, D = 32, 5
MIN_NOISE = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, size=(N, D)).astype(np.float32)
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2]
    y = ((y - y.mean()) / y.std()).astype(np.float32)
    mask = np.ones(N, np.float32)
    mask[-6:] = 0.0  # padded tail, as the bucketed history has
    X[-6:] = 0.0
    y[-6:] = 0.0
    cat = np.zeros(D, dtype=bool)
    raws = np.stack(
        [np.zeros(D + 2), np.r_[rng.normal(0, 0.7, D + 1), np.log(1e-2)], rng.normal(0, 1, D + 2)]
    ).astype(np.float32)
    return X, y, mask, cat, raws


def test_matern52_matches_reference(data):
    X, _, _, _, raws = data
    cat = np.array([False, False, False, True, False])
    Xc = X.copy()
    Xc[:, 3] = np.round(Xc[:, 3] * 2)
    for raw in raws:
        ref_p = ref_gp.GPParams(jnp.exp(raw[:D]), jnp.exp(raw[D]), jnp.exp(raw[D + 1]))
        port_p = port_gp.params_from_raw(t32(raw), D, 0.0)
        ref_k = ref_gp.matern52(Xc, Xc[:7], ref_p, cat)
        port_k = port_gp.matern52(t32(Xc), t32(Xc[:7]), port_p, t32(cat, torch.bool))
        np.testing.assert_allclose(np64(port_k), np64(ref_k), rtol=0, atol=5e-7)


def test_batched_matern52_matches_per_start(data):
    X, _, _, cat, raws = data
    batched = port_gp.matern52(t32(X), t32(X), port_gp.params_from_raw(t32(raws), D, 0.0), t32(cat, torch.bool))
    for s, raw in enumerate(raws):
        one = port_gp.matern52(t32(X), t32(X), port_gp.params_from_raw(t32(raw), D, 0.0), t32(cat, torch.bool))
        np.testing.assert_allclose(np64(batched[s]), np64(one), rtol=0, atol=5e-7)


def test_mll_loss_and_gradient_match_jax_value_and_grad(data):
    X, y, mask, cat, raws = data
    r = t32(raws).requires_grad_(True)
    port_loss = port_gp._loss(r, t32(X), t32(y), t32(cat, torch.bool), t32(mask), MIN_NOISE)
    (port_grad,) = torch.autograd.grad(port_loss.sum(), r)
    vg = jax.value_and_grad(lambda q: ref_gp._loss(q, X, y, cat, mask, MIN_NOISE))
    for s, raw in enumerate(raws):
        ref_val, ref_grad = vg(jnp.asarray(raw))
        np.testing.assert_allclose(float(port_loss[s].detach()), float(ref_val), rtol=2e-5)
        np.testing.assert_allclose(np64(port_grad[s]), np64(ref_grad), rtol=2e-3, atol=2e-3)


def test_mll_of_a_failed_cholesky_is_the_guard_value(data):
    X, y, mask, cat, _ = data
    raw = np.r_[np.zeros(D), 0.0, np.log(1e-2)].astype(np.float32)
    bad_mask = mask.copy()
    bad_mask[:] = 1.0
    Xd = np.repeat(X[:1], N, axis=0)  # every row identical: rank one + tiny noise
    port = port_gp._loss(t32(raw), t32(Xd), t32(y), t32(cat, torch.bool), t32(bad_mask), -1e-2)
    ref = ref_gp._loss(raw, Xd, y, cat, bad_mask, -1e-2)
    assert float(port) == float(ref) == 1e10


@pytest.fixture(scope="module")
def fitted(data):
    """A reference state (fixed raw params, its own finalize) carried across."""
    X, y, mask, cat, raws = data
    ref_state, ref_rung = ref_gp._finalize_state(raws[1], X, y, cat, mask, MIN_NOISE)
    port_state = convert.gp_state_from_numpy(ref_state, device="cpu")
    return ref_state, int(ref_rung), port_state


def test_convert_carries_every_field(fitted):
    ref_state, _, port_state = fitted
    for f in ("X", "y", "mask", "L", "alpha"):
        np.testing.assert_array_equal(np64(getattr(port_state, f)), np64(getattr(ref_state, f)))
    for f in ("inv_sq_lengthscales", "scale", "noise"):
        np.testing.assert_array_equal(
            np64(getattr(port_state.params, f)), np64(getattr(ref_state.params, f))
        )


def test_state_for_matches_reference_finalize(data, fitted):
    from optuna_tpu_torch.gp.fused import _state_for

    X, y, mask, cat, raws = data
    ref_state, ref_rung, _ = fitted
    params = port_gp.params_from_raw(t32(raws[1]), D, MIN_NOISE)
    state, rung = _state_for(params, t32(X), t32(y), t32(cat, torch.bool), t32(mask))
    assert rung == ref_rung
    np.testing.assert_allclose(np64(state.L), np64(ref_state.L), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np64(state.alpha), np64(ref_state.alpha), rtol=1e-3, atol=1e-3)


def test_posterior_and_logei_with_gradients_match(fitted):
    ref_state, _, port_state = fitted
    rng = np.random.RandomState(5)
    xq = rng.uniform(0, 1, size=(17, D)).astype(np.float32)
    cat = np.zeros(D, dtype=bool)
    mean_r, var_r = ref_gp.posterior(ref_state, xq, cat)
    mean_p, var_p = port_gp.posterior(port_state, t32(xq), t32(cat, torch.bool))
    np.testing.assert_allclose(np64(mean_p), np64(mean_r), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np64(var_p), np64(var_r), rtol=0, atol=2e-5)

    best = float(np.max(np.asarray(ref_state.y)))
    ref_data = ref_acqf.LogEIData(ref_state, cat, jnp.float32(best), jnp.float32(1e-10))
    port_data = LogEIData(port_state, t32(cat, torch.bool), torch.tensor(best), torch.tensor(1e-10))
    ref_v, ref_g = jax.value_and_grad(lambda x: jnp.sum(ref_acqf.logei_value(ref_data, x)))(xq)
    xr = t32(xq).requires_grad_(True)
    port_v = logei_value(port_data, xr)
    (port_g,) = torch.autograd.grad(port_v.sum(), xr)
    np.testing.assert_allclose(np64(port_v), np64(ref_acqf.logei_value(ref_data, xq)), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(port_v.detach().sum()), float(ref_v), rtol=1e-5)
    np.testing.assert_allclose(np64(port_g), np64(ref_g), rtol=1e-3, atol=1e-4)


def test_log_h_and_its_gradient_match():
    z = np.linspace(-40.0, 8.0, 481).astype(np.float32)
    ref_v, ref_g = jax.vmap(jax.value_and_grad(lambda q: ref_log_h(q)))(z)
    zt = t32(z).requires_grad_(True)
    port_v = port_log_h(zt)
    (port_g,) = torch.autograd.grad(port_v.sum(), zt)
    np.testing.assert_allclose(np64(port_v), np64(ref_v), rtol=2e-6, atol=2e-6)
    # Relative 5e-5 on the gradient: at z = -40 it is ~40 and comes through
    # erfcx's asymptotic series, whose f32 terms round differently.
    np.testing.assert_allclose(np64(port_g), np64(ref_g), rtol=5e-5, atol=1e-5)


def _plan_grams():
    space = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(3)}
    params = ref_gp.GPParams(jnp.ones(3), jnp.asarray(1.0), jnp.asarray(1e-7))
    out = []
    for plan in PATHOLOGICAL_HISTORY_PLANS:
        rng = np.random.RandomState(0)
        X = np.asarray(
            [[plan.params_fn(i, rng, space)[f"x{j}"] for j in range(3)] for i in range(plan.n_trials)],
            dtype=np.float32,
        )
        bare = np.asarray(ref_gp.matern52(X, X, params, np.zeros(3, bool)))
        noisy = np.asarray(ref_gp._kernel_with_noise(X, params, np.zeros(3, bool), np.ones(len(X), np.float32)))
        out += [(f"{plan.name}-bare", bare), (f"{plan.name}-noisy", noisy)]
    out += [("zeros", np.zeros((6, 6), np.float32)), ("negative", -np.eye(5, dtype=np.float32))]
    return out


@pytest.mark.parametrize("name,K", _plan_grams(), ids=[n for n, _ in _plan_grams()])
def test_ladder_rungs_match_on_pathological_grams(name, K):
    L_ref, rung_ref = ref_res.ladder_cholesky_with_rung(jnp.asarray(K))
    L_port, rung_port = port_res.ladder_cholesky_with_rung(t32(K))
    assert rung_port == int(rung_ref)
    finite_ref = bool(np.all(np.isfinite(np.asarray(L_ref))))
    assert bool(torch.isfinite(L_port).all()) == finite_ref
    if finite_ref:
        # Near-singular Grams have ill-conditioned factors: compare what the
        # factor reproduces, not its entries.
        Lr = np64(L_ref)
        np.testing.assert_allclose(np64(L_port @ L_port.T), Lr @ Lr.T, rtol=0, atol=1e-5)


def test_ladder_gives_up_with_nan_after_every_rung():
    L, rung = port_res.ladder_cholesky_with_rung(-torch.eye(4))
    assert rung == port_res._LADDER_MAX_RUNGS
    assert bool(torch.isnan(L).all())


def test_collapse_duplicate_rows_and_clip_match():
    rng = np.random.RandomState(1)
    X = rng.uniform(size=(9, 3)).astype(np.float32)
    X[4] = X[1]
    X[7] = X[1]
    X[8] = X[2]
    y = rng.normal(size=9)
    for a, b in zip(port_res.collapse_duplicate_rows(X, y), ref_res.collapse_duplicate_rows(X, y)):
        np.testing.assert_array_equal(a, b)
    vals = np.array([np.inf, -np.inf, 1e308, 2.0])
    np.testing.assert_array_equal(port_res.clip_objective_values(vals), ref_res.clip_objective_values(vals))


def test_rank1_raise_matches_reference():
    rng = np.random.RandomState(2)
    A = rng.normal(size=(12, 12)).astype(np.float32)
    K = (A @ A.T + 12 * np.eye(12)).astype(np.float32)
    v = rng.normal(size=12).astype(np.float32)
    L = np.linalg.cholesky(K).astype(np.float32)
    L_ref, rung_ref, rf_ref = ref_res.ladder_cholesky_rank1_raise(
        jnp.asarray(L), jnp.asarray(v), lambda: jnp.asarray(K + np.outer(v, v))
    )
    L_port, rung_port, rf_port = port_res.ladder_cholesky_rank1_raise(
        t32(L), t32(v), lambda: t32(K + np.outer(v, v))
    )
    assert (rung_port, rf_port) == (int(rung_ref), int(rf_ref)) == (0, 0)
    np.testing.assert_allclose(np64(L_port), np64(L_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np64(L_port @ L_port.T), K + np.outer(v, v), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------ L-BFGS-B

_A = np.array([[3.0, 0.5, 0.0, 0.2], [0.5, 2.0, 0.3, 0.0], [0.0, 0.3, 1.5, 0.1], [0.2, 0.0, 0.1, 1.0]], np.float32)


def _problem(b):
    """Batched convex quadratic 0.5 xᵀAx − bᵀx (+ a quartic) in both packages."""

    def ref_vg(x):
        f = lambda r: 0.5 * r @ jnp.asarray(_A) @ r - jnp.asarray(b) @ r + 0.05 * jnp.sum(r**4)  # noqa: E731
        return jax.vmap(jax.value_and_grad(f))(x)

    def port_vg(x):
        with torch.enable_grad():
            r = x.detach().requires_grad_(True)
            f = 0.5 * torch.einsum("bi,ij,bj->b", r, t32(_A), r) - r @ t32(b) + 0.05 * torch.sum(r**4, dim=1)
            (g,) = torch.autograd.grad(f.sum(), r)
        return f.detach(), g

    return ref_vg, port_vg


@pytest.mark.parametrize(
    "b,max_iters",
    [
        (np.array([40.0, -30.0, 25.0, -20.0], np.float32), 50),  # optimum outside: converges at a corner
        (np.array([1.0, -0.5, 0.25, 0.3], np.float32), 6),  # interior optimum: cut at max_iters
    ],
    ids=["corner-converged", "interior-truncated"],
)
def test_lbfgsb_same_iterations_and_solution(b, max_iters):
    x0 = np.array([[0.0, 0.0, 0.0, 0.0], [1.5, -1.5, 0.5, 0.0], [-1.0, 1.0, -1.9, 1.9]], np.float32)
    lower = np.full(4, -2.0, np.float32)
    upper = np.full(4, 2.0, np.float32)
    ref_vg, port_vg = _problem(b)
    x_r, f_r, n_r = ref_lbfgsb(ref_vg, jnp.asarray(x0), jnp.asarray(lower), jnp.asarray(upper),
                               max_iters=max_iters, max_ls=12, return_n_iter=True)
    x_p, f_p, n_p = port_lbfgsb(port_vg, t32(x0), t32(lower), t32(upper),
                                max_iters=max_iters, max_ls=12, return_n_iter=True)
    assert n_p == int(n_r)
    np.testing.assert_allclose(np64(x_p), np64(x_r), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np64(f_p), np64(f_r), rtol=1e-5, atol=1e-5)
