"""The port's truncated normal (``optuna_tpu_torch/ops/truncnorm.py``)
against the reference's (``optuna_tpu/ops/truncnorm.py``) and against
``scipy.stats.truncnorm`` in float64, and the all ``-inf`` row of the
port's ``logsumexp``.

Tolerances (measured on a grid of 15 edges in [-40, 40] squared, float32):
- ``ppf``, |a|, |b| < 5.5, q in [1e-3, 0.999]: 3.3e-6 from the reference,
  7.5e-7 from float64. Held to ``ATOL_NEAR`` = 1e-5.
- ``ppf`` with a far bound (|a| or |b| >= 5.5), same q: 3.4e-5 from the
  reference, 2.3e-5 from float64. Held to ``ATOL_FAR`` = 1e-4.
- ``ppf`` at q in {1e-6, 1 - 1e-6} with a far bound: 0.0113 from float64.
  The reference is 26.9 off there (its float32 ``ndtri`` of ~1e-33 clips
  to the far bound at (12, 40)), so only float64 holds the port:
  ``ATOL_EXTREME_Q`` = 0.02.
- ``log_mass``: 2.1e-7 of max(1, |value|) from the reference; 1.96e-3 from
  float64 at (8, 12), where both frameworks' float32 ``log_ndtr(-8)`` is
  0.068 off. Held to ``RTOL_LOG_MASS_REF`` = 1e-6 and ``RTOL_LOG_MASS_F64``
  = 3e-3.
- ``logpdf``: 2.1e-6 of max(1, |value|) from the reference, 1.3e-6 from
  float64. Held to ``RTOL_LOGPDF`` = 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import truncnorm as scipy_truncnorm

from optuna_tpu.ops import truncnorm as ref
from optuna_tpu_torch.ops import special
from optuna_tpu_torch.ops import truncnorm as port

ATOL_NEAR = 1e-5
ATOL_FAR = 1e-4
ATOL_EXTREME_Q = 0.02
RTOL_LOG_MASS_REF = 1e-6
RTOL_LOG_MASS_F64 = 3e-3
RTOL_LOGPDF = 1e-5

EDGES = np.array([-40.0, -12.0, -8.0, -5.5, -3.0, -1.0, -0.25, 0.0, 0.3, 1.0, 2.5, 5.5, 8.0, 12.0, 40.0])


def _grid(qs):
    a, b = (m.ravel() for m in np.meshgrid(EDGES, EDGES, indexing="ij"))
    keep = b > a
    a, b = a[keep], b[keep]
    q = np.asarray(qs, np.float32)
    return (
        np.repeat(a, len(q)).astype(np.float32),
        np.repeat(b, len(q)).astype(np.float32),
        np.tile(q, len(a)),
    )


def _both(fn_name, *arrays):
    got = getattr(port, fn_name)(*(torch.as_tensor(x) for x in arrays)).numpy()
    want = np.asarray(getattr(ref, fn_name)(*(jnp.asarray(x) for x in arrays)))
    return got.astype(np.float64), want.astype(np.float64)


def _far(a, b):
    return (np.abs(a) >= 5.5) | (np.abs(b) >= 5.5)


@pytest.mark.parametrize("region, atol", [("near", ATOL_NEAR), ("far", ATOL_FAR)])
def test_ppf_matches_reference_and_scipy(region, atol):
    a, b, q = _grid([1e-3, 0.1, 0.5, 0.9, 0.999])
    sel = _far(a, b) if region == "far" else ~_far(a, b)
    a, b, q = a[sel], b[sel], q[sel]
    got, want = _both("ppf", q, a, b)
    f64 = scipy_truncnorm.ppf(q.astype(np.float64), a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, f64, rtol=0, atol=atol)


def test_ppf_at_extreme_q_in_far_tails_matches_scipy():
    a, b, q = _grid([1e-6, 1 - 1e-6])
    sel = _far(a, b)
    a, b, q = a[sel], b[sel], q[sel]
    got = port.ppf(torch.as_tensor(q), torch.as_tensor(a), torch.as_tensor(b)).numpy().astype(np.float64)
    f64 = scipy_truncnorm.ppf(q.astype(np.float64), a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(got, f64, rtol=0, atol=ATOL_EXTREME_Q)


def test_ppf_at_the_last_float32_quantiles_stays_in_bounds():
    # q = 1 - 1e-7 rounds to the float32 below 1; both frameworks' float32
    # ndtri saturates there, so only the bounds are held.
    a, b, q = _grid([1e-7, 1 - 1e-7])
    got = port.ppf(torch.as_tensor(q), torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.isfinite(got).all()
    assert (got >= a).all() and (got <= b).all()


def test_log_mass_matches_reference_and_float64():
    from scipy.special import log_ndtr

    a, b, _ = _grid([0.5])
    got, want = _both("log_mass", a, b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    # float64 oracle in the left-tail orientation (mass is symmetric).
    flip = a64 > 0
    lo, hi = np.where(flip, -b64, a64), np.where(flip, -a64, b64)
    f64 = log_ndtr(hi) + np.log1p(-np.exp(log_ndtr(lo) - log_ndtr(hi)))
    scale = np.maximum(1.0, np.abs(f64))
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want) / scale) <= RTOL_LOG_MASS_REF
    assert np.max(np.abs(got - f64) / scale) <= RTOL_LOG_MASS_F64


def test_logpdf_matches_reference_and_scipy():
    a, b, frac = _grid([0.1, 0.5, 0.9])
    x = np.clip(a + frac * np.minimum(b - a, 5.0), -40, 40).astype(np.float32)
    got, want = _both("logpdf", x, a, b)
    f64 = scipy_truncnorm.logpdf(x.astype(np.float64), a.astype(np.float64), b.astype(np.float64))
    fin = np.isfinite(f64)
    scale = np.maximum(1.0, np.abs(f64[fin]))
    assert np.max(np.abs(got[fin] - want[fin]) / scale) <= RTOL_LOGPDF
    assert np.max(np.abs(got[fin] - f64[fin]) / scale) <= RTOL_LOGPDF
    # Outside the support: -inf on both sides.
    out = port.logpdf(torch.tensor([-2.0, 3.0]), torch.tensor([-1.0, -1.0]), torch.tensor([1.0, 1.0]))
    assert torch.isneginf(out).all()


@pytest.mark.parametrize("fn_name", ["ppf", "logpdf", "log_mass"])
def test_degenerate_interval_matches_reference(fn_name):
    # b <= a: an empty interval. log_mass is -inf, and ppf/logpdf give what
    # the reference's selects give, never NaN from an unselected branch.
    rng = np.random.RandomState(3)
    a = rng.uniform(-9, 9, 64).astype(np.float32)
    b = (a - rng.uniform(0, 3, 64) * (np.arange(64) % 2)).astype(np.float32)  # half equal, half below
    q = rng.uniform(0, 1, 64).astype(np.float32)
    args = {"ppf": (q, a, b), "logpdf": (a, a, b), "log_mass": (a, b)}[fn_name]
    got, want = _both(fn_name, *args)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_NEAR)
    if fn_name == "log_mass":
        assert np.isneginf(got).all()


def test_logsumexp_of_all_neg_inf_is_neg_inf():
    from jax.scipy.special import logsumexp

    rows = np.array(
        [[-np.inf] * 4, [0.0, -np.inf, 1.0, -np.inf], [-3.0, -2.0, -1.0, 0.0]], np.float32
    )
    got = special.logsumexp(torch.as_tensor(rows), dim=1).numpy()
    want = np.asarray(logsumexp(jnp.asarray(rows), axis=1))
    assert np.isneginf(got[0]) and np.isneginf(want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
