"""The port's scan loop pieces against the reference, on the CPU, from the
same numpy-seeded inputs.

* ``ladder_cholesky_rank1_update`` (the exact chunk's row append) on every
  plan of ``PATHOLOGICAL_HISTORY_PLANS``: posterior mean and variance
  within atol/rtol 5e-3 of the reference's (the tolerance of
  ``tests/test_rank1_cholesky.py``), the same ``refactored`` flag and the
  same rung. On the rank-deficient append that must fall back, the same
  flag (1) and rung, and the posterior of the full refactorization it
  delegates to (the reference's own check there).
* ``_make_decode`` on a mixed space: categorical and Int columns exactly,
  floats within 1e-6 relative (both decode in f32; ``exp`` may differ in
  the last ulp).
* ``hartmann6_torch`` / ``hartmann20_torch`` against their ``_jax`` twins
  within rtol 1e-6.
* The inducing-set seeder: the same farthest-point picks.
* One exact chunk (d = 5, bucket 64, chunk 8) and one sparse chunk (d = 5,
  bucket 128, m_pad 16, chunk 8). The reference's compiled chunk program
  runs with its key; the port's runs from ``scan_carry_from_numpy`` of the
  same carry with the reference's own draws (``fold_in(key, i)``, split
  into the candidate shift and the start Gumbels) and the reference's
  Sobol pool. Compared: the fitted loss, both winners scored by the
  reference's ``_loss`` (rtol 1e-4); the first proposal's LogEI under the
  model that proposed it (atol 1e-3); ``chunk_fill``, ``quarantined`` and
  ``rank1_updates + refactorizations`` exactly; the history rows below
  ``n_real`` bit for bit. Proposals after the first may part in f32 (the
  L-BFGS trajectories do, see ``tests/test_torch_fused.py``), so they are
  held to the box and to finiteness only.
* The ``DEVICE_STATS`` vocabulary and aggregations.
* On the card (marker ``cuda``): the card-against-CPU sparse chunk of
  ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optuna_tpu import device_stats as ref_device_stats
from optuna_tpu.distributions import CategoricalDistribution as RefCat
from optuna_tpu.distributions import FloatDistribution as RefFloat
from optuna_tpu.distributions import IntDistribution as RefInt
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.gp.acqf import LogEIData as RefLogEIData
from optuna_tpu.gp.acqf import logei_value as ref_logei
from optuna_tpu.gp.search_space import SearchSpace as RefSpace
from optuna_tpu.gp.sparse import sgpr_reduce as ref_sgpr_reduce
from optuna_tpu.models.benchmarks import hartmann6_jax, hartmann20_jax
from optuna_tpu.parallel import scan_loop as ref_scan
from optuna_tpu.parallel.vectorized import VectorizedObjective as RefObjective
from optuna_tpu.samplers import _resilience as ref_res
from optuna_tpu.testing.fault_injection import PATHOLOGICAL_HISTORY_PLANS
from optuna_tpu_torch import device_stats
from optuna_tpu_torch.distributions import CategoricalDistribution, FloatDistribution, IntDistribution
from optuna_tpu_torch.gp import gp as port_gp
from optuna_tpu_torch.gp.convert import scan_carry_from_numpy
from optuna_tpu_torch.gp.search_space import SearchSpace
from optuna_tpu_torch.models.benchmarks import hartmann6_torch, hartmann20_torch
from optuna_tpu_torch.parallel import scan_loop as port_scan
from optuna_tpu_torch.parallel.vectorized import VectorizedObjective
from optuna_tpu_torch.samplers import _resilience as port_res
from optuna_tpu_torch.samplers._gp.sampler import _DeviceSpace
from tests._torch_port import cuda_device, np64, t32  # noqa: F401

D = 5
CHUNK = 8
N_PRELIM = 128
N_LOCAL = 4
LBFGS_ITERS = 16
MIN_NOISE = 1e-5
N_STARTS, FIT_ITERS = port_scan._SCAN_COLD_FIT


# ------------------------------------------------------ rank-1 row append


PLAN_SPACE = {"a": RefFloat(0.0, 1.0), "b": RefFloat(0.0, 1.0)}


def _plan_design(plan):
    """A plan's (X, y) design over a 2-dim float space: the params/value
    stream ``populate`` would seed a study with, clipped and standardized."""
    rng = np.random.RandomState(0)
    params = [plan.params_fn(i, rng, PLAN_SPACE) for i in range(plan.n_trials)]
    values = np.asarray([plan.value_fn(i) for i in range(plan.n_trials)])
    X = RefSpace(PLAN_SPACE).normalize(params).astype(np.float32)
    y = ref_res.clip_objective_values(values).astype(np.float32)
    mu, sd = float(np.mean(y)), float(np.std(y))
    return X, ((y - mu) / (sd if sd > 1e-12 else 1.0)).astype(np.float32)


def _append_inputs(X, y, bucket=16):
    n, d = X.shape
    Xp = np.zeros((bucket, d), np.float32)
    Xp[:n] = X
    yp = np.zeros(bucket, np.float32)
    yp[:n] = y
    prior = np.zeros(bucket, np.float32)
    prior[: n - 1] = 1.0
    new = prior.copy()
    new[n - 1] = 1.0
    queries = np.random.RandomState(1).uniform(0, 1, (6, d)).astype(np.float32)
    return Xp, yp, prior, new, queries


def _ref_append(X, y, scale, noise):
    """The reference: factor rows < n-1, append row n-1; the posterior at six
    queries, the rung and the flag."""
    n, d = X.shape
    Xp, yp, prior, new, q = (jnp.asarray(a) for a in _append_inputs(X, y))
    params = ref_gp.GPParams(jnp.ones(d, jnp.float32), jnp.float32(scale), jnp.float32(noise))
    cat = jnp.zeros(d, bool)
    L, _ = ref_res.ladder_cholesky_with_rung(ref_gp._kernel_with_noise(Xp, params, cat, prior))
    k_vec = ref_gp.matern52(Xp[n - 1][None], Xp, params, cat)[0]
    k_row = jnp.where(jnp.arange(len(Xp)) == n - 1, params.scale + params.noise + ref_gp._JITTER, k_vec)
    L_new, rung, refac = ref_res.ladder_cholesky_rank1_update(
        L, k_row, jnp.asarray(n - 1, jnp.int32), lambda: ref_gp._kernel_with_noise(Xp, params, cat, new)
    )
    alpha = jax.scipy.linalg.cho_solve((L_new, True), yp)
    state = ref_gp.GPState(params=params, X=Xp, y=yp, mask=new, L=L_new, alpha=alpha)
    mean, var = ref_gp.posterior(state, q, cat)
    return np.asarray(mean), np.asarray(var), int(rung), int(refac)


def _port_append(X, y, scale, noise):
    n, d = X.shape
    Xp, yp, prior, new, q = (t32(a) for a in _append_inputs(X, y))
    params = port_gp.GPParams(torch.ones(d), torch.tensor(scale), torch.tensor(noise))
    cat = torch.zeros(d, dtype=torch.bool)
    L, _ = port_res.ladder_cholesky_with_rung(port_gp._kernel_with_noise(Xp, params, cat, prior))
    k_vec = port_gp.matern52(Xp[n - 1][None], Xp, params, cat)[0]
    k_row = torch.where(torch.arange(len(Xp)) == n - 1, params.scale + params.noise + port_gp._JITTER, k_vec)
    L_new, rung, refac = port_res.ladder_cholesky_rank1_update(
        L, k_row, n - 1, lambda: port_gp._kernel_with_noise(Xp, params, cat, new)
    )
    assert torch.isfinite(L_new).all()

    def post(L):
        alpha = torch.cholesky_solve(yp[:, None], L)[:, 0]
        state = port_gp.GPState(params=params, X=Xp, y=yp, mask=new, L=L, alpha=alpha)
        mean, var = port_gp.posterior(state, q, cat)
        return np64(mean), np64(var)

    L_full, _ = port_res.ladder_cholesky_with_rung(port_gp._kernel_with_noise(Xp, params, cat, new))
    return post(L_new), post(L_full), rung, refac


APPEND_CASES = [(p, 1.0, 1e-4) for p in PATHOLOGICAL_HISTORY_PLANS]
# Every row identical under a deterministic noise floor: the Schur pivot is
# spent and the append must fall back to the full ladder refactorization.
APPEND_CASES.append((next(p for p in PATHOLOGICAL_HISTORY_PLANS if p.name == "identical_params"), 4.0, 1e-7))


@pytest.mark.parametrize(
    "plan,scale,noise", APPEND_CASES, ids=[f"{p.name}-noise{n:g}" for p, _, n in APPEND_CASES]
)
def test_rank1_update_matches_the_reference(plan, scale, noise):
    X, y = _plan_design(plan)
    m_ref, v_ref, rung_ref, refac_ref = _ref_append(X, y, scale, noise)
    (m_port, v_port), full, rung_port, refac_port = _port_append(X, y, scale, noise)
    assert refac_port == refac_ref
    assert rung_port == rung_ref
    if noise == 1e-7:
        # The fallback: a rank-one Gram regularized by the jitter ladder,
        # whose posterior mean is f32 round-off in both packages (alpha is
        # ~1/jitter). Held, as the reference holds its own, to the full
        # refactorization it delegates to.
        assert refac_port == 1
        np.testing.assert_allclose(m_port, full[0], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(v_port, full[1], rtol=1e-3, atol=1e-4)
        return
    np.testing.assert_allclose(m_port, m_ref, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(v_port, v_ref, rtol=5e-3, atol=5e-3)


# ------------------------------------------------------------- decode, objectives


def test_decode_matches_the_reference_on_a_mixed_space():
    ref_space = {
        "lr": RefFloat(1e-4, 1.0, log=True),
        "width": RefInt(4, 64),
        "odd": RefInt(1, 9, step=2),
        "drop": RefFloat(0.0, 0.5, step=0.1),
        "act": RefCat(["relu", "tanh", "gelu"]),
        "u": RefFloat(-2.0, 3.0),
    }
    port_space = {
        "lr": FloatDistribution(1e-4, 1.0, log=True),
        "width": IntDistribution(4, 64),
        "odd": IntDistribution(1, 9, step=2),
        "drop": FloatDistribution(0.0, 0.5, step=0.1),
        "act": CategoricalDistribution(["relu", "tanh", "gelu"]),
        "u": FloatDistribution(-2.0, 3.0),
    }
    x = RefSpace(ref_space).sample_normalized(64, seed=3).astype(np.float32)
    x[:4] = np.array([0.0, 1.0, -0.1, 1.1], np.float32)[:, None]  # the edges and beyond
    ref = ref_scan._make_decode(RefSpace(ref_space))(jnp.asarray(x))
    port = port_scan._make_decode(SearchSpace(port_space))(t32(x))
    for name in ("width", "odd", "act"):
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
    assert port["act"].dtype == torch.int32
    for name in ("lr", "drop", "u"):
        np.testing.assert_allclose(np64(port[name]), np64(ref[name]), rtol=1e-6, atol=0)


def test_hartmann_twins_match_the_reference():
    x = np.random.RandomState(5).uniform(0, 1, (257, 20)).astype(np.float32)
    ref_params = {f"x{i}": jnp.asarray(x[:, i]) for i in range(20)}
    port_params = {f"x{i}": t32(x[:, i]) for i in range(20)}
    np.testing.assert_allclose(np64(hartmann6_torch(port_params)), np64(hartmann6_jax(ref_params)), rtol=1e-6)
    np.testing.assert_allclose(np64(hartmann20_torch(port_params)), np64(hartmann20_jax(ref_params)), rtol=1e-6)


def test_device_stats_vocabulary_matches_the_reference():
    assert device_stats.DEVICE_STATS == ref_device_stats.DEVICE_STATS
    assert device_stats.STAT_AGGREGATIONS == ref_device_stats.STAT_AGGREGATIONS


# ------------------------------------------------------------ chunk programs


def _ref_f(p):
    x = jnp.stack([p[f"x{i}"] for i in range(D)], axis=-1)
    return jnp.sum((x - 0.3) ** 2, axis=-1) - 0.2 * jnp.sin(6.0 * x[:, 0])


def _port_f(p):
    x = torch.stack([p[f"x{i}"] for i in range(D)], dim=-1)
    return torch.sum((x - 0.3) ** 2, dim=-1) - 0.2 * torch.sin(6.0 * x[:, 0])


def _history(n_real, bucket, seed):
    """A minimized objective's loop-top carry: scores (negated values) of
    ``n_real`` uniform points in a ``bucket`` buffer, plus cold-fit starts."""
    rng = np.random.RandomState(seed)
    X = np.zeros((bucket, D), np.float32)
    X[:n_real] = rng.uniform(size=(n_real, D))
    x = X[:n_real].astype(np.float64)
    y = np.zeros(bucket, np.float32)
    y[:n_real] = -(np.sum((x - 0.3) ** 2, axis=1) - 0.2 * np.sin(6 * x[:, 0]))
    mask = np.zeros(bucket, np.float32)
    mask[:n_real] = 1.0
    default = np.r_[np.zeros(D + 1), np.log(1e-2)].astype(np.float32)
    starts = np.stack([default] + [default + rng.normal(size=D + 2).astype(np.float32) for _ in range(N_STARTS - 1)])
    return X, y, mask, starts


def _ref_draws(key, n_cand):
    """Each step's (shift, gumbel) as the reference's chunk derives them."""
    shifts, gumbels = [], []
    for i in range(CHUNK):
        k_cand, k_start = jax.random.split(jax.random.fold_in(key, i))
        shifts.append(np.asarray(jax.random.uniform(k_cand, (D,), dtype=jnp.float32)))
        gumbels.append(np.asarray(jax.random.gumbel(k_start, (n_cand,), dtype=jnp.float32)))
    return t32(np.stack(shifts)), t32(np.stack(gumbels))


@pytest.fixture(scope="module")
def spaces():
    ref_obj = RefObjective(_ref_f, {f"x{i}": RefFloat(0.0, 1.0) for i in range(D)})
    port_obj = VectorizedObjective(_port_f, {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(D)})
    ref_space, port_space = RefSpace(ref_obj.search_space), SearchSpace(port_obj.search_space)
    ref_dev = ref_scan._device_space(ref_obj, ref_space, N_PRELIM)
    # The reference's pool is its device Sobol; the port's chunk gets the same.
    port_dev = _DeviceSpace(port_space, N_PRELIM, torch.device("cpu"))
    port_dev.sobol_base = t32(ref_dev.sobol_base)
    return (ref_obj, ref_space, ref_dev), (port_obj, port_space, port_dev)


def _ref_first_logei(raw, X, y_std, mask, x0, Z=None, zy_std=None, zmask=None):
    """LogEI of the reference's first proposal under the model that proposed
    it: the chunk-start factorization (exact) or reduction (sparse)."""
    raw = jnp.asarray(raw)
    cat = jnp.zeros(D, bool)
    params = ref_gp.GPParams(jnp.exp(raw[:D]), jnp.exp(raw[D]), jnp.exp(raw[D + 1]) + MIN_NOISE)
    if Z is None:
        L, _ = ref_res.ladder_cholesky_with_rung(ref_gp._kernel_with_noise(X, params, cat, mask))
        alpha = jax.scipy.linalg.cho_solve((L, True), y_std)
        state = ref_gp.GPState(params=params, X=X, y=y_std, mask=mask, L=L, alpha=alpha)
    else:
        state = ref_sgpr_reduce(params, Z, zy_std, zmask, X, y_std, mask, cat)[0]
    best = jnp.max(jnp.where(mask > 0, y_std, -jnp.inf))
    data = RefLogEIData(state=state, cat_mask=cat, best=best, stabilizing_noise=jnp.float32(1e-10))
    return float(ref_logei(data, jnp.asarray(x0)[None])[0])


def _standardized(y, mask):
    n = max(mask.sum(), 1.0)
    mu = np.float32((y * mask).sum() / n)
    sd = np.float32(np.sqrt(max((mask * (y - mu) ** 2).sum() / n, 0.0)))
    return mu, sd, np.where(mask > 0, (y - mu) / sd, 0.0).astype(np.float32)


@pytest.fixture(scope="module")
def exact_chunk(spaces):
    (ref_obj, ref_space, ref_dev), (port_obj, port_space, port_dev) = spaces
    n_real, bucket = 40, 64
    X, y, mask, starts = _history(n_real, bucket, seed=1)
    key = jax.random.PRNGKey(7)
    program = ref_scan._chunk_program(
        ref_obj, ref_space, ref_dev, chunk_len=CHUNK, bucket=bucket, n_starts=N_STARTS,
        fit_iters=FIT_ITERS, minimum_noise=MIN_NOISE, maximize=False,
        n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS,
    )
    ref = program(jnp.asarray(starts), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask), jnp.int32(n_real), key)
    carry = scan_carry_from_numpy(
        {"X": X, "y": y, "m": mask, "n_dev": n_real, "warm_raw": None, "Z": None, "zy": None, "zm": None,
         "bucket": bucket, "m_pad": 0},
        "cpu",
    )
    shifts, gumbels = _ref_draws(key, port_scan._N_INCUMBENTS + N_PRELIM)
    port = port_scan._chunk_program(
        port_obj, port_space, port_dev, fit_iters=FIT_ITERS, minimum_noise=MIN_NOISE, maximize=False,
        n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS,
    )(t32(starts), carry["X"], carry["y"], carry["m"], carry["n_dev"], shifts, gumbels)
    xs, vals, fins, X_f, y_f, mask_f, n_f, raw, stats = ref
    _, _, y_std = _standardized(y, mask)
    ref_out = {
        "xs": np.asarray(xs), "X": np.asarray(X_f), "y": np.asarray(y_f), "mask": np.asarray(mask_f),
        "n": int(n_f), "raw": np.asarray(raw), "stats": {k: int(v) for k, v in stats.items()},
        "logei0": _ref_first_logei(raw, X, y_std, mask, np.asarray(xs)[0]),
    }
    return dict(X=X, y=y, mask=mask, y_std=y_std, n_real=n_real, fit=(X, y_std, mask)), ref_out, port


@pytest.fixture(scope="module")
def sparse_chunk(spaces):
    (ref_obj, ref_space, ref_dev), (port_obj, port_space, port_dev) = spaces
    n_real, bucket, m_pad = 100, 128, 16
    X, y, mask, starts = _history(n_real, bucket, seed=2)
    Z, zy, zm = ref_scan._seed_inducing_program(ref_obj, bucket, m_pad)(jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
    key = jax.random.PRNGKey(9)
    program = ref_scan._chunk_program_sparse(
        ref_obj, ref_space, ref_dev, chunk_len=CHUNK, bucket=bucket, m_pad=m_pad, n_starts=N_STARTS,
        fit_iters=FIT_ITERS, minimum_noise=MIN_NOISE, maximize=False,
        n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS, has_categorical=False,
    )
    ref = program(
        jnp.asarray(starts), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask), jnp.int32(n_real), Z, zy, zm, key
    )
    carry = scan_carry_from_numpy(
        {"X": X, "y": y, "m": mask, "n_dev": n_real, "warm_raw": None, "Z": Z, "zy": zy, "zm": zm,
         "bucket": bucket, "m_pad": m_pad},
        "cpu",
    )
    shifts, gumbels = _ref_draws(key, port_scan._N_INCUMBENTS + N_PRELIM)
    port = port_scan._chunk_program_sparse(
        port_obj, port_space, port_dev, fit_iters=FIT_ITERS, minimum_noise=MIN_NOISE, maximize=False,
        n_local_search=N_LOCAL, lbfgs_iters=LBFGS_ITERS,
    )(t32(starts), carry["X"], carry["y"], carry["m"], carry["n_dev"], carry["Z"], carry["zy"], carry["zm"],
      shifts, gumbels)
    xs, vals, fins, X_f, y_f, mask_f, n_f, Z_f, zy_f, zm_f, raw, stats = ref
    mu, sd, y_std = _standardized(y, mask)
    Z, zy, zm = (np.asarray(a) for a in (Z, zy, zm))
    zy_std = np.where(zm > 0, (zy - mu) / sd, 0.0).astype(np.float32)
    ref_out = {
        "xs": np.asarray(xs), "X": np.asarray(X_f), "y": np.asarray(y_f), "mask": np.asarray(mask_f),
        "n": int(n_f), "raw": np.asarray(raw),
        "stats": {k: float(v) for k, v in stats.items()},
        "logei0": _ref_first_logei(raw, X, y_std, mask, np.asarray(xs)[0], Z, zy_std, zm),
        "zm": np.asarray(zm_f),
    }
    return dict(X=X, y=y, mask=mask, y_std=y_std, n_real=n_real, fit=(Z, zy_std, zm)), ref_out, port


CHUNKS = ["exact_chunk", "sparse_chunk"]


def _ref_loss(raw, X, y, mask):
    return float(ref_gp._loss(jnp.asarray(np64(raw), jnp.float32), X, y, jnp.zeros(D, bool), mask, MIN_NOISE))


@pytest.mark.parametrize("run", CHUNKS)
def test_chunk_fitted_loss_matches(run, request):
    inputs, ref, port = request.getfixturevalue(run)
    loss_ref = _ref_loss(ref["raw"], *inputs["fit"])
    loss_port = _ref_loss(port.raw, *inputs["fit"])
    assert np.isfinite(loss_port)
    np.testing.assert_allclose(loss_port, loss_ref, rtol=1e-4)


@pytest.mark.parametrize("run", CHUNKS)
def test_chunk_first_proposal_logei_matches(run, request):
    _, ref, port = request.getfixturevalue(run)
    np.testing.assert_allclose(float(port.acq[0]), ref["logei0"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("run", CHUNKS)
def test_chunk_counts_match(run, request):
    inputs, ref, port = request.getfixturevalue(run)
    stats = port.stats
    assert int(stats["scan.chunk_fill"]) == ref["stats"]["scan.chunk_fill"] == CHUNK
    assert int(stats["scan.quarantined"]) == ref["stats"]["scan.quarantined"] == 0
    assert (
        int(stats["scan.rank1_updates"]) + int(stats["scan.refactorizations"])
        == ref["stats"]["scan.rank1_updates"] + ref["stats"]["scan.refactorizations"]
    )
    assert port.n == ref["n"] == inputs["n_real"] + CHUNK
    assert port.finites.tolist() == [True] * CHUNK


@pytest.mark.parametrize("run", CHUNKS)
def test_chunk_keeps_the_history_below_n_real_bit_for_bit(run, request):
    inputs, ref, port = request.getfixturevalue(run)
    n = inputs["n_real"]
    for name, got in (("X", port.X), ("y", port.y), ("mask", port.mask)):
        np.testing.assert_array_equal(got[:n].numpy(), ref[name][:n])
        np.testing.assert_array_equal(got[:n].numpy(), inputs[name][:n])
    # The chunk's proposals land above the cursor, in the box.
    xs = port.xs.numpy()
    assert np.isfinite(xs).all() and ((xs >= 0.0) & (xs <= 1.0)).all()
    np.testing.assert_array_equal(port.X[n : n + CHUNK].numpy(), xs)
    np.testing.assert_array_equal(port.mask.numpy(), ref["mask"])


def test_sparse_chunk_inducing_stats(sparse_chunk):
    _, ref, port = sparse_chunk
    assert int(port.stats["gp.inducing_count"]) == int(ref["stats"]["gp.inducing_count"])
    assert port.zmask.numpy().sum() == ref["zm"].sum()
    swaps = int(port.stats["gp.inducing_swaps"])
    assert swaps == sum(port.swaps)
    assert swaps + int(port.stats["scan.rank1_updates"]) + int(port.stats["scan.refactorizations"]) == CHUNK


def test_seed_inducing_picks_match_the_reference():
    X, y, mask, _ = _history(50, 64, seed=4)
    ref = ref_scan._seed_inducing_program(
        RefObjective(_ref_f, {}), 64, 16
    )(jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
    port = port_scan._seed_inducing_program(16)(t32(X), t32(y), t32(mask))
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scan_carry_from_numpy_types():
    X, y, mask, _ = _history(10, 32, seed=0)
    carry = scan_carry_from_numpy(
        {"X": jnp.asarray(X), "y": y, "m": mask, "n_dev": jnp.int32(10), "warm_raw": np.zeros(D + 2, np.float32),
         "Z": None, "zy": None, "zm": None, "bucket": 32, "m_pad": 0},
        "cpu",
    )
    assert carry["n_dev"] == 10 and carry["bucket"] == 32 and carry["m_pad"] == 0
    assert carry["Z"] is None and carry["warm_raw"].shape == (D + 2,)
    for f in ("X", "y", "m"):
        assert carry[f].dtype == torch.float32 and carry[f].device.type == "cpu"
    np.testing.assert_array_equal(carry["X"].numpy(), X)


@pytest.mark.cuda
def test_sparse_chunk_card_against_cpu(cuda_device):  # noqa: F811
    import chip_smoke

    chip_smoke.phase_scan_chunk(cuda_device)
