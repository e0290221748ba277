"""QMC of the port against the reference, on the CPU: both are SciPy's
engines on the host, so every point is equal bit for bit — the
``QMCSampler`` studies (Sobol and Halton, scrambled or not) and
``halton_sample`` / ``normal_qmc_sample`` / ``sobol_sample``. The device
tier's ``sobol_sample_device`` is exact integer arithmetic on both sides,
so it too is held bit for bit: unshifted, and at one shift vector."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.stats import qmc

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.ops import qmc as ref_qmc
from optuna_tpu_torch.ops import qmc as port_qmc

optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)
optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)


@pytest.mark.parametrize("fn", ["sobol_sample", "halton_sample", "normal_qmc_sample"])
@pytest.mark.parametrize("n,dim,seed", [(1, 3, 0), (17, 5, 1), (64, 2, 7), (100, 12, None)])
def test_qmc_samples_equal_the_reference_bit_for_bit(fn, n, dim, seed):
    if seed is None:  # unseeded engines draw fresh scrambles: only shapes and ranges agree
        got = getattr(port_qmc, fn)(n, dim)
        assert got.shape == (n, dim) and np.isfinite(got).all()
        return
    np.testing.assert_array_equal(getattr(port_qmc, fn)(n, dim, seed), getattr(ref_qmc, fn)(n, dim, seed))


def _objective(trial):
    x = trial.suggest_float("x", -3.0, 3.0)
    y = trial.suggest_float("y", 1e-3, 10.0, log=True)
    k = trial.suggest_int("k", 0, 9)
    s = trial.suggest_int("s", 0, 20, step=4)
    c = trial.suggest_categorical("c", ["a", "b", "c"])
    return x * x + np.log(y) ** 2 + abs(k - 3) + s / 10 + (c != "b")


def _summary(study):
    return (
        [(t.number, t.state.name, t.params, t.values) for t in study.get_trials(deepcopy=False)],
        study._storage.get_study_system_attrs(study._study_id),
    )


@pytest.mark.parametrize("qmc_type", ["sobol", "halton"])
@pytest.mark.parametrize("scramble", [True, False])
def test_qmc_sampler_study_is_bit_for_bit_the_reference(qmc_type, scramble):
    out = []
    for pkg in (optuna_tpu, optuna_tpu_torch):
        sampler = pkg.samplers.QMCSampler(qmc_type=qmc_type, scramble=scramble, seed=3, warn_independent_sampling=False)
        study = pkg.create_study(sampler=sampler)
        study.optimize(_objective, n_trials=24)
        out.append(_summary(study))
    assert out[0] == out[1]


def test_qmc_sampler_two_objectives_and_a_bad_type():
    out = []
    for pkg in (optuna_tpu, optuna_tpu_torch):
        study = pkg.create_study(
            directions=["minimize", "maximize"], sampler=pkg.samplers.QMCSampler(seed=0, warn_independent_sampling=False)
        )
        study.optimize(lambda t: (t.suggest_float("a", 0, 1), t.suggest_float("b", 0, 1)), n_trials=10)
        out.append(_summary(study))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="qmc_type"):
        optuna_tpu_torch.samplers.QMCSampler(qmc_type="latin")


# --------------------------------------------------------- device Sobol tier


@pytest.mark.parametrize("n,dim", [(1, 1), (7, 3), (100, 5), (256, 12), (2048, 20)])
def test_sobol_sample_device_unshifted_equals_the_reference_bit_for_bit(n, dim):
    """No shift: the port's int64 XOR pipeline is the reference's uint32 one
    and SciPy's ``scramble=False`` stream, exactly."""
    got = port_qmc.sobol_sample_device(n, dim, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_qmc.sobol_sample_device(n, dim)))
    if n & (n - 1) == 0:  # SciPy warns on other n; the points are the same
        np.testing.assert_array_equal(
            got.numpy().astype(np.float64), qmc.Sobol(d=dim, scramble=False).random(n)
        )


@pytest.mark.parametrize("n,dim,seed", [(64, 2, 0), (300, 7, 1), (2048, 20, 2)])
def test_sobol_device_kernel_with_one_shift_equals_the_reference_bit_for_bit(n, dim, seed):
    """Given one 30-bit shift vector, both sides' kernels agree exactly, and
    the port's seeded entry point is that kernel at the shift its generator
    draws."""
    import jax.numpy as jnp

    shift = np.random.RandomState(seed).randint(0, 1 << 30, size=dim).astype(np.int64)
    sv = ref_qmc._direction_numbers(dim)
    want = np.asarray(ref_qmc._sobol_device_kernel(jnp.asarray(sv), jnp.asarray(shift.astype(np.uint32)), n))
    got = port_qmc._sobol_device_kernel(torch.as_tensor(sv.astype(np.int64)), torch.as_tensor(shift), n)
    np.testing.assert_array_equal(got.numpy(), want)

    drawn = torch.randint(0, 1 << 30, (dim,), generator=torch.Generator().manual_seed(seed), dtype=torch.int64)
    seeded = port_qmc.sobol_sample_device(n, dim, generator=torch.Generator().manual_seed(seed), device="cpu")
    want = np.asarray(ref_qmc._sobol_device_kernel(jnp.asarray(sv), jnp.asarray(drawn.numpy().astype(np.uint32)), n))
    np.testing.assert_array_equal(seeded.numpy(), want)
    assert float(seeded.min()) >= 0.0 and float(seeded.max()) < 1.0


def test_sobol_sample_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no GPU"):
        port_qmc.sobol_sample_device(8, 2)
