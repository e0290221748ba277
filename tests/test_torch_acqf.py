"""The port's acquisitions against the reference's, on the CPU.

One fitted state (the reference's ``fit_gp``, d = 3, n = 24) feeds both
packages. Its targets carry observation noise of sd 0.3, so the posterior
variance stays well above float32's cancellation in ``scale - |v|^2``:
with sd 0.1 the variance near the observations falls to ~1e-4 of the
scale, and both packages' float32 values part from float64 by ~1e-4
relative (a LogEI gradient of -318 by 1e-3), an error of the arithmetic
both share, which no tolerance on their difference can tell apart from
the port's. The reference builds each acquisition's data: the reference builds each acquisition's data, and
``convert.acqf_data_from_numpy`` carries it across. Every entry of
``ACQF_VALUE_FNS`` is then evaluated at the same 32 query points, values
and input gradients (the reference's ``jax.grad`` of the sum; rows are
independent). Tolerances: 1e-4 relative plus 1e-5 absolute; 1e-3 relative
for the LogEHVI entries, whose value sums 128 QMC samples over every box
(the absolute parts scaled as ``_assert_close`` says).

The port's own qLogEI builder (``GPSampler._build_qlogei``) runs from the
converted state and is held to the reference-built data's values. The box
decomposition is host NumPy on both sides: equal bit for bit, and the
reference's volume and disjointness tests run on the port's copy.
``log_ndtr`` (PyTorch's special function) is held to jax's from z = -40
to 8: values within 1e-6 relative plus 1e-7 absolute (jax's float32 value
of log Phi(5) is 1.2e-8 from the float64 one, PyTorch's 1e-14), gradients
within 2e-4 relative (measured 1.2e-4 at z = -39, where both sides are
within 1.2e-4 of float64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optuna_tpu.gp import acqf as ref_acqf
from optuna_tpu.gp import box_decomposition as ref_boxes
from optuna_tpu.gp import gp as ref_gp
from optuna_tpu.ops.qmc import normal_qmc_sample
from optuna_tpu.samplers import GPSampler as RefGPSampler
from optuna_tpu_torch.gp import acqf as port_acqf
from optuna_tpu_torch.gp import box_decomposition as port_boxes
from optuna_tpu_torch.gp.convert import acqf_data_from_numpy
from optuna_tpu_torch.ops.special import log_ndtr
from optuna_tpu_torch.samplers import GPSampler
from tests._torch_port import cuda_device, np64, one_torch_thread, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D = 3
N_OBS = 24
STAB = 1e-10


def _fit(seed, shift=0.0):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(N_OBS, D)).astype(np.float32)
    f = np.sin(3 * X[:, 0] + shift) + (X[:, 1] - 0.4) ** 2 - 0.5 * X[:, 2]
    f = f + 0.3 * np.random.RandomState(seed).normal(size=N_OBS)
    y = ((f - f.mean()) / f.std()).astype(np.float32)
    state, _, _ = ref_gp.fit_gp(X, y, np.zeros(D, bool), seed=seed)
    return X, y, state


def _stack(*states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


@pytest.fixture(scope="module")
def fitted():
    X, y, state = _fit(1)
    _, y2, state2 = _fit(2, shift=1.0)
    _, _, cons = _fit(3, shift=2.0)
    return X, y, state, y2, state2, cons


@pytest.fixture(scope="module")
def ref_data(fitted):
    X, y, state, y2, state2, cons = fitted
    cat = jnp.zeros(D, bool)
    stab = jnp.asarray(STAB, jnp.float32)
    best = jnp.asarray(float(np.max(y)), jnp.float32)
    running = np.random.RandomState(4).uniform(size=(3, D)).astype(np.float32)
    _, qlogei = RefGPSampler(seed=0)._build_qlogei(state, cat, running, float(np.max(y)), 11)
    std = np.stack([-y, -y2], axis=1).astype(np.float64)
    worst = np.max(std, axis=0)
    lowers, uppers = ref_boxes.nondominated_box_decomposition(std, np.maximum(worst * 1.1, worst * 0.9) + 1e-6)
    logehvi = ref_acqf.LogEHVIData(
        states=_stack(state, state2), cat_mask=cat, box_lowers=jnp.asarray(lowers, jnp.float32),
        box_uppers=jnp.asarray(uppers, jnp.float32),
        qmc_z=jnp.asarray(normal_qmc_sample(128, 2, seed=5), jnp.float32), stabilizing_noise=stab,
    )
    logei = ref_acqf.LogEIData(state=state, cat_mask=cat, best=best, stabilizing_noise=stab)
    data = {
        "logei": logei,
        "qlogei": qlogei,
        "logpi": ref_acqf.LogPIData(state=state, cat_mask=cat, best=best, stabilizing_noise=stab),
        "ucb": ref_acqf.UCBData(state=state, cat_mask=cat, beta=jnp.asarray(2.0, jnp.float32)),
        "lcb": ref_acqf.UCBData(state=state, cat_mask=cat, beta=jnp.asarray(2.0, jnp.float32)),
        "logehvi": logehvi,
    }
    for name in ("logei", "qlogei", "logehvi"):
        data[f"constrained_{name}"] = ref_acqf.ConstrainedData(
            base=data[name], constraint_states=_stack(cons, state2), constraint_cat_mask=cat,
            constraint_thresholds=jnp.asarray([0.3, -0.2], jnp.float32), stabilizing_noise=stab,
        )
    return data, running


def _queries():
    return np.random.RandomState(9).uniform(size=(32, D)).astype(np.float32)


def _ref_eval(name, data, x):
    fn = ref_acqf.ACQF_VALUE_FNS[name]
    vals = fn(data, jnp.asarray(x))
    grads = jax.grad(lambda xx: jnp.sum(fn(data, xx)))(jnp.asarray(x))
    return np64(vals), np64(grads)


def _port_eval(name, data, x):
    xr = t32(x).requires_grad_(True)
    vals = port_acqf.ACQF_VALUE_FNS[name](data, xr)
    (grads,) = torch.autograd.grad(vals.sum(), xr)
    return np64(vals), np64(grads)


def _rtol(name):
    return 1e-3 if "logehvi" in name else 1e-4


def _assert_close(got, want, name):
    """Values: ``rtol`` relative plus 1e-5 absolute of the values' scale
    (max 1, the largest |value|); gradients: ``rtol`` relative plus
    ``rtol`` of the largest |component|, so a component that crosses zero
    is held to the gradient's scale, not to itself."""
    (v, g), (rv, rg) = got, want
    rtol = _rtol(name)
    np.testing.assert_allclose(v, rv, rtol=rtol, atol=1e-5 * max(1.0, float(np.max(np.abs(rv)))))
    np.testing.assert_allclose(g, rg, rtol=rtol, atol=rtol * float(np.max(np.abs(rg))) + 1e-5)


def test_the_registry_holds_the_reference_names():
    assert sorted(port_acqf.ACQF_VALUE_FNS) == sorted(ref_acqf.ACQF_VALUE_FNS)


@pytest.mark.parametrize("name", sorted(ref_acqf.ACQF_VALUE_FNS))
def test_value_and_gradient_match_the_reference(name, ref_data):
    data, _ = ref_data
    x = _queries()
    port = _port_eval(name, acqf_data_from_numpy(data[name], "cpu"), x)
    assert np.all(np.isfinite(port[0])) and np.all(np.isfinite(port[1]))
    _assert_close(port, _ref_eval(name, data[name], x), name)


def test_the_ports_qlogei_builder_matches_the_reference_built_data(fitted, ref_data):
    """The port's fantasies come from the same host QMC draws (SciPy), so
    its extended state and per-fantasy alphas give the reference's values."""
    data, running = ref_data
    X, y, state, *_ = fitted
    port_state = acqf_data_from_numpy(ref_acqf.LogEIData(state, jnp.zeros(D, bool), 0.0, 0.0), "cpu").state
    name, built = GPSampler(seed=0, device="cpu")._build_qlogei(
        port_state, torch.zeros(D, dtype=torch.bool), running, float(np.max(y)), 11
    )
    assert name == "qlogei" and built.alphas.shape == (128, N_OBS + 8 + 3)
    np.testing.assert_allclose(np64(built.best), np64(data["qlogei"].best), rtol=1e-5, atol=1e-5)
    x = _queries()
    np.testing.assert_allclose(
        _port_eval("qlogei", built, x)[0], _ref_eval("qlogei", data["qlogei"], x)[0], rtol=1e-4, atol=1e-5
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qlogei", "logehvi", "constrained_logehvi"])
def test_card_against_cpu(name, ref_data, cuda_device):
    data, _ = ref_data
    x = _queries()
    cpu = _port_eval(name, acqf_data_from_numpy(data[name], "cpu"), x)
    card = acqf_data_from_numpy(data[name], cuda_device)
    xr = t32(x).to(cuda_device).requires_grad_(True)
    vals = port_acqf.ACQF_VALUE_FNS[name](card, xr)
    (grads,) = torch.autograd.grad(vals.sum(), xr)
    _assert_close((np64(vals), np64(grads)), cpu, name)


def test_log_ndtr_in_the_tails():
    z = np.linspace(-40.0, 8.0, 97).astype(np.float32)
    ref_v = np64(jax.scipy.special.log_ndtr(jnp.asarray(z)))
    ref_g = np64(jax.grad(lambda zz: jnp.sum(jax.scipy.special.log_ndtr(zz)))(jnp.asarray(z)))
    zr = t32(z).requires_grad_(True)
    v = log_ndtr(zr)
    (g,) = torch.autograd.grad(v.sum(), zr)
    np.testing.assert_allclose(np64(v), ref_v, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np64(g), ref_g, rtol=2e-4, atol=0)


@pytest.mark.parametrize("n,m,seed", [(8, 2, 0), (6, 3, 1), (12, 3, 2), (5, 4, 3)])
def test_box_decomposition_is_the_references(n, m, seed):
    pts = np.random.RandomState(seed).uniform(size=(n, m))
    ref = np.full(m, 1.2)
    got = port_boxes.nondominated_box_decomposition(pts, ref)
    want = ref_boxes.nondominated_box_decomposition(pts, ref)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    capped = port_boxes.nondominated_box_decomposition(pts, ref, max_boxes=3)
    np.testing.assert_array_equal(capped[0], ref_boxes.nondominated_box_decomposition(pts, ref, max_boxes=3)[0])


def test_box_decomposition_2d_volume():
    # Total box volume within [lb, ref] must equal ref-box volume minus HV.
    from optuna_tpu_torch.hypervolume import compute_hypervolume

    pts = np.array([[0.2, 0.8], [0.5, 0.5], [0.8, 0.1]])
    ref = np.array([1.0, 1.0])
    lowers, uppers = port_boxes.nondominated_box_decomposition(pts, ref)
    lb = pts.min(axis=0)  # integrate over [min, ref] only
    clipped_l = np.maximum(lowers, lb)
    vol = np.sum(np.prod(np.maximum(uppers - clipped_l, 0), axis=1))
    hv = compute_hypervolume(pts, ref, device="cpu")
    region = np.prod(ref - lb)
    np.testing.assert_allclose(vol, region - hv, rtol=1e-9)


def test_box_decomposition_disjoint():
    pts = np.random.RandomState(5).uniform(0, 1, (6, 3))
    lowers, uppers = port_boxes.nondominated_box_decomposition(pts, np.ones(3))
    # Pairwise disjoint: for each pair some dim separates them.
    for i in range(len(lowers)):
        for j in range(i + 1, len(lowers)):
            assert not np.all((lowers[i] < uppers[j]) & (lowers[j] < uppers[i])), (i, j)
