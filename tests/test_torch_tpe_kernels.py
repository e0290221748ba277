"""TPE's numeric plane (``optuna_tpu_torch/samplers/_tpe/_kernels.py``)
against the reference's (``optuna_tpu/samplers/_tpe/_kernels.py``) on the
same inputs, made from seeds with numpy, and with the reference's draws
handed in (``tests/_torch_port.py::jax_univariate_draws``).

Tolerances:
- KDE build (mus, sigmas, log-probabilities): ``BUILD_RTOL`` 2e-6 with
  ``BUILD_ATOL`` 1e-6. Both sides are float32; the only differences are
  the order of the categorical row sums and float32 ``log``/``exp``.
- Candidates: the same argmax (or top-k) index, so the same categorical
  values and numerical values within ``CAND_ATOL`` 5e-5 of the transformed
  domain (the truncated-normal ``ppf`` differs by up to 3.4e-5 in standard
  units between the frameworks, ``tests/test_torch_truncnorm.py``).
- Scores (``log l - log g``): ``SCORE_ATOL`` 1e-4.
- The device build against the float64 host ``_ParzenEstimator``: rtol
  2e-5, atol 1e-5, as ``tests/test_parzen_parity.py`` holds the
  reference's build to its host estimator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optuna_tpu.samplers._tpe import _kernels as ref
from optuna_tpu.samplers._tpe.parzen_estimator import _bucket
from optuna_tpu.samplers._tpe.sampler import default_weights
from optuna_tpu_torch.samplers._tpe import _kernels as port
from tests._torch_port import cuda_device, jax_joint_draws, jax_univariate_draws  # noqa: F401

BUILD_RTOL, BUILD_ATOL = 2e-6, 1e-6
CAND_ATOL = 5e-5
SCORE_ATOL = 1e-4
CPU = torch.device("cpu")

# A mixed space in the reference's transformed layout: a uniform float, a
# log float, an int in [1, 64] (half-step widened), a stepped float; three
# categoricals with 4, 2 and 3 choices.
LOWS = np.array([-3.0, np.log(1e-5), 0.5, -1.25], np.float32)
HIGHS = np.array([3.0, np.log(1e-1), 64.5, 2.25], np.float32)
STEPS = np.array([0.0, 0.0, 1.0, 0.5], np.float32)
N_CHOICES = np.array([4, 2, 3], np.int32)
CMAX = 4


def _dist_mats(with_dist: bool):
    mats = np.zeros((len(N_CHOICES), CMAX, CMAX), np.float32)
    has = np.zeros(len(N_CHOICES), bool)
    if with_dist:
        idx = np.arange(CMAX)
        mats[0] = np.abs(idx[:, None] - idx[None, :])
        mats[2, :3, :3] = (idx[:3, None] != idx[None, :3]) * 2.0
        has[[0, 2]] = True
    return mats, has


def _obs_set(rng, n: int, duplicates: bool = True):
    """The reference's per-set arguments: (obs_num, obs_cat, log_w, n, n_k)."""
    b = _bucket(n + 1)
    num = np.zeros((len(LOWS), b), np.float32)
    for d in range(len(LOWS)):
        if STEPS[d] > 0:
            k = rng.randint(0, int(round((HIGHS[d] - LOWS[d]) / STEPS[d])), n)
            if duplicates:
                k = k % 5  # a few values, many repeats
            num[d, :n] = LOWS[d] + 0.5 * STEPS[d] + k * STEPS[d]
        else:
            num[d, :n] = rng.uniform(LOWS[d], HIGHS[d], n)
    cat = np.zeros((len(N_CHOICES), b), np.int32)
    for d, c in enumerate(N_CHOICES):
        cat[d, :n] = rng.randint(0, c, n)
    w = np.append(default_weights(n), 1.0)
    w /= w.sum()
    log_w = np.full(b, -np.inf, np.float32)
    log_w[: n + 1] = np.log(np.maximum(w, 1e-12))
    return num, cat, log_w, n, np.float32(n + 1)


def _port_inputs(sets, with_dist, magic_clip, device=CPU):
    mats, has = _dist_mats(with_dist)
    space = port.make_space(LOWS, HIGHS, STEPS, N_CHOICES, mats, has, device)
    obs = port.upload_obs(sets, LOWS, HIGHS, N_CHOICES, 1.0, magic_clip, space.dist_mats is not None, device)
    return space, obs


def _ref_args(b, a, with_dist):
    mats, has = _dist_mats(with_dist)
    return (
        *b, *a, LOWS, HIGHS, STEPS, N_CHOICES, np.float32(1.0), mats, has,
    )


def _assert_candidates_close(got, want):
    """Numerical candidates within ``CAND_ATOL`` of each dim's transformed width."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) / (HIGHS - LOWS)
    assert err.max(initial=0.0) <= CAND_ATOL, f"max error {err.max()} of the width: {got} vs {want}"


# ------------------------------------------------------------------ the build


@pytest.mark.parametrize("n", [0, 1, 2, 7, 40])
@pytest.mark.parametrize("consider_endpoints", [False, True])
@pytest.mark.parametrize("magic_clip", [True, False])
def test_build_num_matches_reference(n, consider_endpoints, magic_clip):
    rng = np.random.RandomState(n)
    num, cat, log_w, _, n_k = _obs_set(rng, n)
    if n >= 2:
        num[0, : n // 2] = num[0, 0]  # equal observations in a continuous dim
    space, (obs,) = _port_inputs([(num, cat, log_w, n, n_k)], False, magic_clip)
    mus, sigmas = port.build_num(obs, space, consider_endpoints)
    for d in range(len(LOWS)):
        want_mu, want_sigma = ref._build_num_dim(
            jnp.asarray(num[d]), jnp.int32(n), jnp.float32(LOWS[d]), jnp.float32(HIGHS[d]),
            consider_endpoints, magic_clip, jnp.float32(n_k),
        )
        np.testing.assert_allclose(mus[d].numpy(), np.asarray(want_mu), rtol=BUILD_RTOL, atol=BUILD_ATOL)
        np.testing.assert_allclose(sigmas[d].numpy(), np.asarray(want_sigma), rtol=BUILD_RTOL, atol=BUILD_ATOL)


@pytest.mark.parametrize("magic_clip", [True, False])
def test_build_num_all_equal_observations_take_the_domain_floor(magic_clip):
    n = 9
    num, cat, log_w, _, n_k = _obs_set(np.random.RandomState(1), n)
    num[:, :n] = (LOWS + 0.5 * (HIGHS - LOWS))[:, None]  # zero variance in every dim
    space, (obs,) = _port_inputs([(num, cat, log_w, n, n_k)], False, magic_clip)
    mus, sigmas = port.build_num(obs, space, consider_endpoints=False)
    for d in range(len(LOWS)):
        _, want = ref._build_num_dim(
            jnp.asarray(num[d]), jnp.int32(n), jnp.float32(LOWS[d]), jnp.float32(HIGHS[d]),
            False, magic_clip, jnp.float32(n_k),
        )
        np.testing.assert_allclose(sigmas[d].numpy(), np.asarray(want), rtol=BUILD_RTOL, atol=BUILD_ATOL)
        if not magic_clip:  # SIGMA_DOMAIN_FLOOR * (high - low)
            assert sigmas[d, :n].min().item() == pytest.approx(1e-7 * float(HIGHS[d] - LOWS[d]), rel=1e-6)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 40])
@pytest.mark.parametrize("with_dist", [False, True])
def test_build_cat_matches_reference(n, with_dist):
    rng = np.random.RandomState(100 + n)
    num, cat, log_w, _, n_k = _obs_set(rng, n)
    mats, has = _dist_mats(with_dist)
    space, (obs,) = _port_inputs([(num, cat, log_w, n, n_k)], with_dist, True)
    got = port.build_cat(obs, space).numpy()
    for d, c in enumerate(N_CHOICES):
        want = np.asarray(ref._build_cat_dim(
            jnp.asarray(cat[d]), jnp.int32(n), jnp.int32(c), jnp.float32(1.0), jnp.float32(n_k), CMAX,
            jnp.asarray(mats[d]), jnp.asarray(has[d]),
        ))
        np.testing.assert_array_equal(np.isneginf(got[d]), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[d][fin], want[fin], rtol=BUILD_RTOL, atol=BUILD_ATOL)


# ------------------------------------------------------ draw, score, argmax


def _problem(seed: int, n_below: int, n_above: int, with_dist: bool):
    rng = np.random.RandomState(seed)
    return _obs_set(rng, n_below), _obs_set(rng, n_above), with_dist


# (seed, below, above, distance kernel, consider_endpoints): each case is a
# compile of the reference's program, so the cases share their flags.
CASES = [(0, 3, 27, False, False), (1, 25, 275, True, True)]


@pytest.mark.parametrize("seed, n_below, n_above, with_dist, consider_endpoints", CASES)
def test_sample_univariate_with_reference_draws(seed, n_below, n_above, with_dist, consider_endpoints):
    b, a, with_dist = _problem(seed, n_below, n_above, with_dist)
    s, draw_seed = 24, 1000 + seed
    want_num, want_cat = ref.sample_univariate_from_obs(
        np.uint32(draw_seed), *_ref_args(b, a, with_dist), n_samples=s,
        consider_endpoints=consider_endpoints, magic_clip=True, cat_cmax=CMAX,
    )
    space, (below, above) = _port_inputs([b, a], with_dist, True)
    draws = jax_univariate_draws(draw_seed, len(LOWS), len(N_CHOICES), s, len(b[2]), CMAX, CPU)
    got_num, got_cat = port.sample_univariate_from_obs(below, above, space, draws, consider_endpoints)
    np.testing.assert_array_equal(got_cat.numpy(), np.asarray(want_cat))
    _assert_candidates_close(got_num.numpy(), np.asarray(want_num))


@pytest.mark.parametrize("seed, n_below, n_above, with_dist, consider_endpoints", CASES)
def test_sample_and_score_with_reference_draws(seed, n_below, n_above, with_dist, consider_endpoints):
    b, a, with_dist = _problem(seed, n_below, n_above, with_dist)
    s, draw_seed = 24, 2000 + seed
    want_num, want_cat = ref.sample_and_score_from_obs(
        np.uint32(draw_seed), *_ref_args(b, a, with_dist), n_samples=s,
        consider_endpoints=consider_endpoints, magic_clip=True, cat_cmax=CMAX,
    )
    space, (below, above) = _port_inputs([b, a], with_dist, True)
    draws = jax_joint_draws(draw_seed, len(LOWS), len(N_CHOICES), s, len(b[2]), CMAX, CPU)
    got_num, got_cat = port.sample_and_score_from_obs(below, above, space, draws, consider_endpoints)
    np.testing.assert_array_equal(got_cat.numpy(), np.asarray(want_cat))
    _assert_candidates_close(got_num.numpy(), np.asarray(want_num))


@jax.jit
def _ref_joint_score(key, b_num, b_cat, b_log_w, b_n, b_nk, a_num, a_cat, a_log_w, a_n, a_nk, mats, has):
    """The reference's own joint samples and scores, from its program's parts."""
    packs = [
        ref._make_joint_pack(
            num, cat, log_w, n, nk, jnp.asarray(LOWS), jnp.asarray(HIGHS), jnp.asarray(STEPS),
            jnp.asarray(N_CHOICES), jnp.float32(1.0), mats, has, True, True, CMAX,
        )
        for num, cat, log_w, n, nk in ((b_num, b_cat, b_log_w, b_n, b_nk), (a_num, a_cat, a_log_w, a_n, a_nk))
    ]
    x_num, x_cat = ref._sample_from(key, packs[0], 24)
    score = ref._component_log_pdf(x_num, x_cat, packs[0]) - ref._component_log_pdf(x_num, x_cat, packs[1])
    return x_num, x_cat, score


def test_joint_scores_and_argmax_index_match_reference():
    seed, n_below, n_above, with_dist, consider_endpoints = CASES[1]
    b, a, with_dist = _problem(seed, n_below, n_above, with_dist)
    draw_seed = 2500
    ref_num, ref_cat, ref_score = (
        np.asarray(t) for t in _ref_joint_score(jax.random.PRNGKey(np.uint32(draw_seed)), *b, *a, *_dist_mats(True))
    )
    space, (below, above) = _port_inputs([b, a], with_dist, True)
    draws = jax_joint_draws(draw_seed, len(LOWS), len(N_CHOICES), 24, len(b[2]), CMAX, CPU)
    joint = lambda o: port._joint_mixture(o, space, consider_endpoints)  # noqa: E731
    x_num, x_cat, score = port._score(joint(below), joint(above), draws)
    np.testing.assert_array_equal(x_cat[0].numpy(), ref_cat)
    _assert_candidates_close(x_num[0].numpy(), ref_num)
    np.testing.assert_allclose(score[0].numpy(), ref_score, rtol=0, atol=SCORE_ATOL)
    assert int(torch.argmax(score[0])) == int(np.argmax(ref_score))


@pytest.mark.parametrize("seed, n_below, n_above, with_dist, _", CASES[:1])
def test_sample_and_score_topk_with_reference_draws(seed, n_below, n_above, with_dist, _):
    b, a, with_dist = _problem(seed, n_below, n_above, with_dist)
    k, s, draw_seed = 6, 24, 3000 + seed
    want_num, want_cat = ref.sample_and_score_topk_from_obs(
        np.uint32(draw_seed), *_ref_args(b, a, with_dist), n_samples=s, k=k,
        consider_endpoints=False, magic_clip=True, cat_cmax=CMAX,
    )
    space, (below, above) = _port_inputs([b, a], with_dist, True)
    draws = jax_joint_draws(draw_seed, len(LOWS), len(N_CHOICES), s, len(b[2]), CMAX, CPU)
    got_num, got_cat = port.sample_and_score_topk_from_obs(below, above, space, draws, k, False)
    np.testing.assert_array_equal(got_cat.numpy(), np.asarray(want_cat))
    _assert_candidates_close(got_num.numpy(), np.asarray(want_num))


# ------------------------------------------------------------- selection


def test_argmax_and_topk_pick_as_the_reference_at_nan_inf_and_ties():
    # log l - log g can be -inf - (-inf) = NaN; ties are common at +-inf.
    rows = np.array(
        [
            [1.0, np.nan, 3.0, np.nan, np.inf],
            [1.0, 3.0, 3.0, np.inf, np.inf],
            [-np.inf, -np.inf, -np.inf, -np.inf, -np.inf],
            [2.0, 2.0, 2.0, 2.0, 2.0],
            [np.nan, np.nan, 0.0, 0.0, 0.0],
        ],
        np.float32,
    )
    t = torch.as_tensor(rows)
    np.testing.assert_array_equal(torch.argmax(t, dim=1).numpy(), np.asarray(jnp.argmax(jnp.asarray(rows), axis=1)))
    finite_ties = rows[1:4]
    got = torch.sort(torch.as_tensor(finite_ties), dim=1, descending=True, stable=True).indices[:, :3]
    want = np.asarray(jax.lax.top_k(jnp.asarray(finite_ties), 3)[1])
    np.testing.assert_array_equal(got.numpy(), want)


def test_stable_sort_assigns_gaps_of_duplicates_as_the_reference():
    # Integer dims hold many equal observations: which of them gets which
    # neighbour gap follows the stable order, on both sides.
    obs = np.array([5.5, 2.5, 5.5, 5.5, 1.5, 2.5, 0, 0], np.float32)
    n = 6
    log_w = np.full(8, -np.inf, np.float32)
    log_w[: n + 1] = 0.0
    set_ = (obs[None], np.zeros((0, 8), np.int32), log_w, n, np.float32(n + 1))
    space = port.make_space(
        np.float32([0.5]), np.float32([9.5]), np.float32([1.0]), np.zeros(0, np.int32),
        np.zeros((0, 1, 1), np.float32), np.zeros(0, bool), CPU,
    )
    (obs_t,) = port.upload_obs([set_], np.float32([0.5]), np.float32([9.5]), np.zeros(0), 1.0, False, False, CPU)
    _, sigmas = port.build_num(obs_t, space, consider_endpoints=False)
    _, want = ref._build_num_dim(jnp.asarray(obs), jnp.int32(n), jnp.float32(0.5), jnp.float32(9.5), False, False,
                                 jnp.float32(n + 1))
    np.testing.assert_array_equal(sigmas[0].numpy(), np.asarray(want))


# ------------------------------------------------------------ draw and pack


def test_draws_are_seeded_and_shaped():
    num, cat = port.univariate_draws(7, 3, 2, 24, 16, 4, CPU)
    again, _ = port.univariate_draws(7, 3, 2, 24, 16, 4, CPU)
    assert num.comp.shape == (3, 24, 16) and num.uniform.shape == (3, 24, 1)
    assert cat.comp.shape == (2, 24, 16) and cat.cat.shape == (2, 24, 1, 4)
    assert torch.equal(num.comp, again.comp) and torch.equal(num.uniform, again.uniform)
    assert ((num.uniform >= 0) & (num.uniform < 1)).all() and torch.isfinite(cat.cat).all()
    joint = port.joint_draws(7, 3, 2, 24, 16, 4, CPU)
    assert joint.comp.shape == (1, 24, 16) and joint.uniform.shape == (1, 24, 3) and joint.cat.shape == (1, 24, 2, 4)


def test_upload_packs_both_sets_into_one_buffer():
    rng = np.random.RandomState(4)
    b, a = _obs_set(rng, 5), _obs_set(rng, 30)
    _, (below, above) = _port_inputs([b, a], True, True)
    for o, s in ((below, b), (above, a)):
        np.testing.assert_array_equal(o.num.numpy(), s[0])
        np.testing.assert_array_equal(o.cat.numpy(), s[1])
        np.testing.assert_array_equal(o.log_w.numpy(), s[2])
        assert o.n == s[3] and o.cat.dtype == torch.int64
    # Every float view shares one storage: one host-to-device copy.
    assert below.num.untyped_storage().data_ptr() == above.log_w.untyped_storage().data_ptr()


@pytest.mark.cuda
def test_argmax_and_topk_on_the_card_pick_as_on_the_cpu(cuda_device):  # noqa: F811
    rows = torch.tensor(
        [
            [1.0, float("nan"), 3.0, float("nan"), float("inf")],
            [1.0, 3.0, 3.0, float("inf"), float("inf")],
            [-float("inf")] * 5,
            [2.0] * 5,
        ]
    )
    card = rows.to(cuda_device)
    assert torch.equal(torch.argmax(card, dim=1).cpu(), torch.argmax(rows, dim=1))
    ties = rows[1:]
    order = lambda t: torch.sort(t, dim=1, descending=True, stable=True).indices  # noqa: E731
    assert torch.equal(order(ties.to(cuda_device)).cpu(), order(ties))


@pytest.mark.cuda
def test_sampling_on_the_card_matches_the_cpu(cuda_device):  # noqa: F811
    """The same inputs and draws on the card and on the CPU: the same
    choices, candidates within the float32 tolerance."""
    b, a, with_dist = _problem(1, 10, 90, True)
    s = 24
    out = {}
    for dev in (CPU, cuda_device):
        space, (below, above) = _port_inputs([b, a], with_dist, True, dev)
        uni = jax_univariate_draws(11, len(LOWS), len(N_CHOICES), s, len(b[2]), CMAX, dev)
        joint = jax_joint_draws(12, len(LOWS), len(N_CHOICES), s, len(b[2]), CMAX, dev)
        out[dev.type] = (
            port.sample_univariate_from_obs(below, above, space, uni, False),
            port.sample_and_score_from_obs(below, above, space, joint, False),
        )
    for (cpu_num, cpu_cat), (gpu_num, gpu_cat) in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(gpu_cat.cpu().numpy(), cpu_cat.numpy())
        _assert_candidates_close(gpu_num.cpu().numpy(), cpu_num.numpy())


@pytest.mark.parametrize("n", [0, 3, 12])
def test_host_parzen_estimator_matches_reference_and_the_device_build(n):
    """The re-homed host estimator equals the reference's bit for bit, and
    the batched build on the device matches it (the host is float64)."""
    import optuna_tpu
    import optuna_tpu_torch
    from optuna_tpu.samplers._tpe.parzen_estimator import _ParzenEstimator as RefPE
    from optuna_tpu.samplers._tpe.parzen_estimator import _ParzenEstimatorParameters as RefParams
    from optuna_tpu_torch.samplers._tpe.parzen_estimator import _ParzenEstimator, _ParzenEstimatorParameters

    rng = np.random.RandomState(n)
    obs = {
        "x": rng.uniform(-3.0, 3.0, n),
        "lr": np.exp(rng.uniform(np.log(1e-5), np.log(1e-1), n)),
        "k": rng.randint(1, 65, n).astype(float),
        "c": rng.randint(0, 4, n).astype(float),
    }
    packs = []
    for mod, pe, params in ((optuna_tpu, RefPE, RefParams), (optuna_tpu_torch, _ParzenEstimator,
                                                             _ParzenEstimatorParameters)):
        d = mod.distributions
        space = {
            "x": d.FloatDistribution(-3.0, 3.0), "lr": d.FloatDistribution(1e-5, 1e-1, log=True),
            "k": d.IntDistribution(1, 64), "c": d.CategoricalDistribution(["a", "b", "c", "d"]),
        }
        packs.append(pe(obs, space, params(True, 1.0, True, False, default_weights, False, {})).pack())
    for key in packs[0]:
        np.testing.assert_array_equal(packs[1][key], packs[0][key])
    host = packs[1]
    lows, highs, steps = (host[k].astype(np.float32) for k in ("lows", "highs", "steps"))
    b = len(host["log_weights"])
    num = np.zeros((3, b), np.float32)
    num[:, :n] = np.stack([obs["x"], np.log(obs["lr"]), obs["k"]]) if n else 0.0
    cat = np.zeros((1, b), np.int32)
    cat[0, :n] = obs["c"]
    space = port.make_space(lows, highs, steps, np.array([4]), np.zeros((1, 4, 4), np.float32), np.zeros(1, bool), CPU)
    (o,) = port.upload_obs([(num, cat, host["log_weights"], n, n + 1)], lows, highs, np.array([4]), 1.0, True, False,
                           CPU)
    mus, sigmas = port.build_num(o, space, consider_endpoints=False)
    np.testing.assert_allclose(mus[:, : n + 1].numpy().T, host["mus"][: n + 1], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(sigmas[:, : n + 1].numpy().T, host["sigmas"][: n + 1], rtol=2e-5, atol=1e-5)
    probs = port.build_cat(o, space)[0, : n + 1].numpy()
    np.testing.assert_allclose(probs, host["cat_log_probs"][: n + 1, 0], rtol=2e-5, atol=1e-5)
