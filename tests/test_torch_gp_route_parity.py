"""The GP sampler's host routes against the reference's, on the CPU: the
acquisition each route builds, step by step.

The same seeded history (two floats and a stepped int, 24 rows, two of
them repeats; the values carry observation noise of sd 0.1) goes into a
study of each package, and each sampler makes its asks
(``sample_relative``) from ``RandomState``s of one seed. Spies on
``fit_gp`` and ``optimize_acqf_mixed`` record what each side passed and
got. The port's i-th fit runs, and then hands on the reference's i-th
fitted state, so everything after the fits is compared on one model:

* every ``fit_gp`` call in order, its inputs bit for bit: the design, the
  standardized targets, the duplicate counts (the single-objective host
  fit collapses the repeats into rows that count 2), the seed (``seed``
  for the objective, ``seed + k`` for LogEHVI's k-th objective, ``seed +
  101 + k`` for the k-th constraint) and the warm start (a second ask
  starts objective k's fit from the first ask's raw params for k);
* ``_build_logehvi`` (two and three objectives): the box decomposition of
  the standardized losses, its reference point included, and the QMC
  draws, bit for bit;
* ``_wrap_constraints`` (around LogEI, and around LogEHVI at three
  objectives): the thresholds ``(0 - mu) / sd`` bit for bit;
* ``_build_qlogei`` (LogEI beside a RUNNING trial): the extended design and
  its mask bit for bit; each fantasy's best value within 1e-4 relative,
  the fantasies' weights within 1e-3 of their scale;
* LogEI's incumbent, the standardized targets and the incumbents that join
  the candidate pool, bit for bit;
* each acquisition at 24 query points: within 1e-3 relative plus 1e-3 of
  the values' scale;
* the proposals within 1e-3 in the normalized space, or a near tie of the
  values the two maximizers reached on the one surface: 1e-3 of their
  scale, 2e-2 for LogEHVI. LogEHVI's surface has a kink wherever a QMC
  sample crosses a box edge, and an L-BFGS ascent stops at one; from 256
  starts on this history the port's ascent ended higher than the
  reference's on 17 and lower on 21 (the two-objective ask here parts by
  1.07e-3 of 0.055).

The port's own fits are held by their predictions: posterior mean and
variance at the query points within 2e-2 absolute (measured: 4.4e-3 and
1.1e-2; raw params part by up to 0.076). The targets of a 24-row history
pin a GP's lengthscales loosely, and the f32 loss is flat to ~1e-2 along
them, so two L-BFGS runs stop at different points of one flat valley.
``tests/test_torch_gp_host.py`` holds ``fit_gp`` at 1e-3 on a history
that pins them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.gp import acqf as ref_acqf
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.gp import optim_mixed as ref_om
from optuna_tpu.samplers import GPSampler as RefGPSampler
from optuna_tpu_torch.gp import acqf as port_acqf
from optuna_tpu_torch.gp import gp as port_gp
from optuna_tpu_torch.gp import optim_mixed as port_om
from optuna_tpu_torch.gp.convert import gp_state_from_numpy
from optuna_tpu_torch.samplers import GPSampler
from tests._torch_port import np64, one_torch_thread, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)

N_HISTORY = 24
TOL = 1e-3
FIT_TOL = 2e-2  # the port's own fits; see the module docstring
TIE_LOGEHVI = 2e-2
SEED = 5
SAMPLER_KW = dict(seed=SEED, n_startup_trials=4, n_preliminary_samples=64, n_local_search=2)


def _dists(mod):
    d = mod.distributions
    return {
        "x": d.FloatDistribution(-1.0, 1.0),
        "y": d.FloatDistribution(-1.0, 1.0),
        "k": d.IntDistribution(0, 8, step=2),
    }


def _history(n_obj, n_cons):
    """Params, values and constraint rows from one seed; rows 3 and 9
    repeat rows 2 and 8, values included (a retried trial)."""
    rng = np.random.RandomState(0)
    xs = rng.uniform(-1.0, 1.0, size=(N_HISTORY, 2))
    ks = 2 * rng.randint(0, 5, size=N_HISTORY)
    xs[3], ks[3] = xs[2], ks[2]
    xs[9], ks[9] = xs[8], ks[8]
    noise = 0.1 * rng.normal(size=(N_HISTORY, 5))
    noise[3], noise[9] = noise[2], noise[8]
    rows = []
    for (x, y), k, e in zip(xs, ks, noise):
        params = {"x": float(x), "y": float(y), "k": int(k)}
        values = [(x - 0.3) ** 2 + (y + 0.2) ** 2 + 0.05 * k, (x + 0.5) ** 2 + 0.5 * y, 1.0 - x * y]
        cons = [x + y - 0.5 + 0.05 * k, 0.2 - k / 8.0 + 0.3 * x * y]
        rows.append((params, list(values + e[:3])[:n_obj], list(cons + e[3:])[:n_cons]))
    return rows


def _study(mod, sampler, n_obj, n_cons, running):
    """The history, a RUNNING trial with params when ``running``, and the
    asking trial (RUNNING, no params yet)."""
    study = mod.create_study(sampler=sampler, directions=["minimize"] * n_obj)
    dists = _dists(mod)
    for params, values, cons in _history(n_obj, n_cons):
        attrs = {"constraints": tuple(float(c) for c in cons)} if n_cons else {}
        study.add_trial(mod.create_trial(params=params, distributions=dists, values=values, system_attrs=attrs))
    running_state = mod.trial.TrialState.RUNNING
    if running:
        study.add_trial(mod.create_trial(state=running_state, params={"x": 0.4, "y": -0.3, "k": 4}, distributions=dists))
    study.add_trial(mod.create_trial(state=running_state))
    return study


def _spy(monkeypatch, module, name, log, hand_on=None):
    """Record each call's arguments and result; return the result, or
    ``hand_on(i)`` for the i-th call where that is given."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        log.append((args, kwargs, out))
        return out if hand_on is None else hand_on(len(log) - 1)

    monkeypatch.setattr(module, name, spy)


def _the_references_fit(ref_fits):
    """The port's i-th fit hands on the reference's i-th fitted state."""

    def hand_on(i):
        state, raw, stats = ref_fits[i][2]
        return gp_state_from_numpy(state, "cpu"), np.asarray(raw), stats

    return hand_on


def _asks(mod, monkeypatch, *, n_obj, n_cons, running, n_asks, ref_fits=None):
    """``n_asks`` asks of one sampler: its ``fit_gp`` calls and its
    maximizer calls, in order. With ``ref_fits`` the port's routes go on
    from the reference's fitted states."""
    if mod is optuna_tpu:
        sampler_cls, gp_mod, om_mod, extra = RefGPSampler, ref_gp, ref_om, {}
    else:
        sampler_cls, gp_mod, om_mod, extra = GPSampler, port_gp, port_om, {"device": "cpu"}
    # Never called: the history carries its constraint rows and no trial is told.
    cons_func = (lambda t: (0.0,) * n_cons) if n_cons else None
    sampler = sampler_cls(constraints_func=cons_func, **SAMPLER_KW, **extra)
    study = _study(mod, sampler, n_obj, n_cons, running)
    current = study.trials[-1]
    fits, maxims = [], []
    with monkeypatch.context() as m:
        _spy(m, gp_mod, "fit_gp", fits, None if ref_fits is None else _the_references_fit(ref_fits))
        _spy(m, om_mod, "optimize_acqf_mixed", maxims)
        search_space = sampler.infer_relative_search_space(study, current)
        for _ in range(n_asks):
            sampler.sample_relative(study, current, search_space)
    return sampler, fits, maxims


def _predictions(port_state, ref_state, cat, x):
    mean, var = port_gp.posterior(port_state, t32(x), torch.as_tensor(cat))
    ref_mean, ref_var = ref_gp.posterior(ref_state, jnp.asarray(x, jnp.float32), jnp.asarray(cat))
    return (np64(mean), np64(var)), (np64(ref_mean), np64(ref_var))


def _assert_fits(port_fits, ref_fits, queries, cat):
    assert len(port_fits) == len(ref_fits)
    for i, ((args, kw, (state, raw, _)), (r_args, r_kw, (r_state, r_raw, _))) in enumerate(
        zip(port_fits, ref_fits)
    ):
        for a, b in zip(args, r_args):  # X, y, is_categorical
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert kw.keys() - {"device"} == r_kw.keys() and kw["seed"] == r_kw["seed"]
        if "counts" in kw:
            np.testing.assert_array_equal(kw["counts"], r_kw["counts"])
        # The port's cache holds the reference's raws it was handed, so its
        # warm starts are the reference's bit for bit (or both None).
        warm, r_warm = kw.get("warm_start_raw"), r_kw.get("warm_start_raw")
        assert (warm is None) == (r_warm is None)
        if warm is not None:
            np.testing.assert_array_equal(np.asarray(warm), np.asarray(r_warm))
        (mean, var), (r_mean, r_var) = _predictions(state, r_state, cat, queries)
        np.testing.assert_allclose(mean, r_mean, rtol=0, atol=FIT_TOL, err_msg=f"fit {i} mean")
        np.testing.assert_allclose(var, r_var, rtol=0, atol=FIT_TOL, err_msg=f"fit {i} variance")


def _assert_host_inputs(name, port, ref):
    """The acquisition's host-made fields, bit for bit."""
    assert type(port).__name__ == type(ref).__name__
    eq = np.testing.assert_array_equal
    if name.startswith("constrained_"):
        eq(np64(port.constraint_thresholds), np64(ref.constraint_thresholds))
        eq(np64(port.constraint_states.X), np64(ref.constraint_states.X))
        eq(np64(port.constraint_states.y), np64(ref.constraint_states.y))
        _assert_host_inputs(name[len("constrained_"):], port.base, ref.base)
    elif name == "logehvi":
        eq(np64(port.box_lowers), np64(ref.box_lowers))
        eq(np64(port.box_uppers), np64(ref.box_uppers))
        eq(np64(port.qmc_z), np64(ref.qmc_z))
        eq(np64(port.states.y), np64(ref.states.y))
    elif name == "qlogei":
        eq(np64(port.state.X), np64(ref.state.X))
        eq(np64(port.state.mask), np64(ref.state.mask))
        # One fitted state on both sides, one QMC draw: each fantasy's best
        # value and weights agree to f32 round-off.
        np.testing.assert_allclose(np64(port.best), np64(ref.best), rtol=1e-4, atol=1e-5)
        alphas, r_alphas = np64(port.alphas), np64(ref.alphas)
        np.testing.assert_allclose(alphas, r_alphas, rtol=0, atol=TOL * float(np.max(np.abs(r_alphas))))
    else:
        eq(np64(port.state.y), np64(ref.state.y))
        eq(np64(port.state.mask), np64(ref.state.mask))
        eq(np64(port.best), np64(ref.best))


def _assert_acquisition(name, port, ref, queries):
    got = np64(port_acqf.ACQF_VALUE_FNS[name](port, t32(queries)))
    want = np64(ref_acqf.ACQF_VALUE_FNS[name](ref, jnp.asarray(queries, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, float(np.max(np.abs(want)))))


def _assert_proposals(name, x_port, v_port, x_ref, v_ref):
    """Within 1e-3, or a near tie of the values each maximizer reached on
    the same surface (before the stepped dim is snapped to its grid)."""
    if np.max(np.abs(x_port - x_ref)) <= TOL:
        return
    tie = TIE_LOGEHVI if "logehvi" in name else TOL
    assert abs(v_port - v_ref) <= tie * max(1.0, abs(v_ref)), (x_port, x_ref, v_port, v_ref)


ROUTES = {
    "constrained logei, two asks": dict(n_obj=1, n_cons=2, running=False, n_asks=2),
    "logei beside a running trial": dict(n_obj=1, n_cons=0, running=True, n_asks=1),
    "logehvi, two objectives, two asks": dict(n_obj=2, n_cons=0, running=False, n_asks=2),
    "constrained logehvi, three objectives": dict(n_obj=3, n_cons=1, running=False, n_asks=1),
}
# Per route: the acquisition, and the seed offsets of an ask's fits.
EXPECTED = {
    "constrained logei, two asks": ("constrained_logei", [0, 101, 102]),
    "logei beside a running trial": ("qlogei", [0]),
    "logehvi, two objectives, two asks": ("logehvi", [0, 1]),
    "constrained logehvi, three objectives": ("constrained_logehvi", [0, 1, 2, 101]),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_host_route_builds_the_references_acquisition(route, monkeypatch):
    kw = ROUTES[route]
    ref_sampler, ref_fits, ref_maxims = _asks(optuna_tpu, monkeypatch, **kw)
    port_sampler, port_fits, port_maxims = _asks(optuna_tpu_torch, monkeypatch, ref_fits=ref_fits, **kw)
    space = port_maxims[0][0][2]  # the sampler's own space, its dims in its order
    queries = space.sample_normalized(24, seed=9).astype(np.float32)
    cat = np.asarray(space.is_categorical)

    acqf, offsets = EXPECTED[route]
    n_fits = len(offsets)
    assert len(port_fits) == n_fits * kw["n_asks"]
    # Each ask draws its seed first; the fits are offset from it.
    for ask in range(kw["n_asks"]):
        seeds = [f[1]["seed"] for f in port_fits[ask * n_fits:(ask + 1) * n_fits]]
        assert [s - seeds[0] for s in seeds] == offsets
    _assert_fits(port_fits, ref_fits, queries, cat)

    assert len(port_maxims) == len(ref_maxims) == kw["n_asks"]
    for (args, m_kw, (x, v)), (r_args, r_m_kw, (r_x, r_v)) in zip(port_maxims, ref_maxims):
        name, data = args[:2]
        assert name == r_args[0] == acqf
        _assert_host_inputs(name, data, r_args[1])
        np.testing.assert_array_equal(m_kw["extra_candidates"], r_m_kw["extra_candidates"])
        _assert_acquisition(name, data, r_args[1], queries)
        _assert_proposals(name, x, v, r_x, r_v)

    # The warm-start cache holds one raw per objective, and the second ask
    # starts the objective's fit from the first's raw params.
    sig = next(iter(port_sampler._kernel_params_cache))
    assert len(port_sampler._kernel_params_cache[sig]) == kw["n_obj"]
    assert len(ref_sampler._kernel_params_cache[sig]) == kw["n_obj"]
    if kw["n_asks"] == 2:
        # The second ask starts objective k's fit from the first ask's raw
        # params for objective k.
        for k in range(kw["n_obj"]):
            assert port_fits[k][1]["warm_start_raw"] is None
            np.testing.assert_array_equal(port_fits[n_fits + k][1]["warm_start_raw"], ref_fits[k][2][1])
    if kw["n_obj"] == 1:
        # The two repeated rows collapse: 12 rows, two of them counted twice.
        counts = port_fits[0][1]["counts"]
        assert len(counts) == N_HISTORY - 2 and sorted(counts)[-2:] == [2.0, 2.0]
