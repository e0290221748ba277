"""The plain references against the port at a tiny size on the CPU, and the
isolation of the references and of the module check."""

from __future__ import annotations

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import isolation
from bench_port.reference import tpe as ref_tpe
from bench_port.reference.mlp import train_one

BENCH = Path(__file__).resolve().parents[1]


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("optuna_tpu_torch", "optuna_tpu", "jax", "jaxlib", "flax"), path


@pytest.mark.parametrize(
    "names, found",
    [
        (["optuna_tpu_torch", "optuna_tpu_torch.gp", "numpy"], []),
        (["optuna_tpu.samplers", "torch"], ["optuna_tpu"]),
        (["jaxlib.xla_client", "jax", "flax.linen"], ["flax", "jax", "jaxlib"]),
        (["jaxtyping", "optuna_tpu_tools"], []),
    ],
)
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert isolation.forbidden_modules(names) == found


SPACE = {"lr": {"low": 0.001, "high": 1.0, "log": True}, "init_scale": {"low": 0.3, "high": 3.0, "log": False}}
LOWS = np.array([math.log(0.001), 0.3])
HIGHS = np.array([0.0, 3.0])


def _tpe_study(n: int, seed: int = 3):
    """A CPU study of config #5's space with ``n`` finished trials of a
    smooth objective, and the trials in working coordinates."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.samplers import TPESampler
    from optuna_tpu_torch.trial import create_trial

    ot.logging.set_verbosity(ot.logging.WARNING)
    dists = {k: FloatDistribution(v["low"], v["high"], log=v["log"]) for k, v in SPACE.items()}
    rng = np.random.default_rng(seed)
    x = rng.uniform(LOWS, HIGHS, size=(n, 2))
    values = (x[:, 0] + 2.5) ** 2 + (x[:, 1] - 1.2) ** 2 + 0.1 * rng.standard_normal(n)
    study = ot.create_study(sampler=TPESampler(seed=seed, multivariate=True, device="cpu"))
    for row, v in zip(x, values):
        study.add_trial(create_trial(params={"lr": math.exp(row[0]), "init_scale": row[1]}, distributions=dists, value=v))
    return study, dists, x, values


def test_tpe_reference_density_ratio_agrees_with_the_port():
    from optuna_tpu_torch.samplers._tpe import _kernels
    from optuna_tpu_torch.samplers._tpe.sampler import _split_trials

    study, dists, x, values = _tpe_study(300)
    sampler = study.sampler
    trials = study.get_trials(deepcopy=False)
    below_t, above_t = _split_trials(study, trials, sampler._gamma(len(trials)), False, device="cpu")
    spec = sampler._univariate_space_spec(dists)
    below, above, _ = sampler._upload(study, spec, below_t, above_t)
    mix_l = _kernels._joint_mixture(below, spec["space"], False)
    mix_g = _kernels._joint_mixture(above, spec["space"], False)
    points = np.random.default_rng(9).uniform(LOWS, HIGHS, size=(200, 2))
    pts = torch.as_tensor(points, dtype=torch.float32)[None]
    none = torch.zeros((1, 200, 0), dtype=torch.long)
    port = (_kernels._log_pdf(pts, none, mix_l) - _kernels._log_pdf(pts, none, mix_g))[0].double().numpy()
    ref = ref_tpe.Ratio(x, values, LOWS, HIGHS).score(points).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=2e-3)


def test_port_batch_proposals_match_the_reference_asks():
    study, dists, x, values = _tpe_study(300, seed=4)
    proposals = study.sampler.sample_relative_batch(study, dists, 256)
    p = np.array([[math.log(r["lr"]), r["init_scale"]] for r in proposals])
    ratio = ref_tpe.Ratio(x, values, LOWS, HIGHS)
    # At 256 proposals the Kolmogorov-Smirnov distance of a sound ask is a
    # few hundredths; uniform draws and unscored draws from l(x) lie far off.
    assert ref_tpe.ask_distance(ratio, p, 256, 16, np.random.default_rng(1)) < 0.15
    uniform = np.random.default_rng(2).uniform(LOWS, HIGHS, size=(256, 2))
    assert ref_tpe.ask_distance(ratio, uniform, 256, 16, np.random.default_rng(3)) > 0.4
    unscored = ratio.below.sample(256, np.random.default_rng(4)).numpy()
    assert ref_tpe.ask_distance(ratio, unscored, 256, 16, np.random.default_rng(5)) > 0.3


def test_ks_distance_hand_count():
    assert ref_tpe.ks_distance(np.array([1.0, 2.0, 3.0, 4.0]), np.array([3.5, 5.0])) == pytest.approx(0.75)
    assert ref_tpe.ks_distance(np.arange(5.0), np.arange(5.0)) == 0.0


def test_reference_mixture_samples_follow_its_density():
    mix = ref_tpe.Mixture(np.array([[-3.0, 1.0], [-1.0, 2.5]]), LOWS, HIGHS)
    draws = mix.sample(200_000, np.random.default_rng(0)).numpy()
    assert np.all((draws >= LOWS) & (draws <= HIGHS))
    # The histogram of the first coordinate against the density integrated
    # over the second, on a grid.
    grid = np.linspace(LOWS[0], HIGHS[0], 41)
    hist, _ = np.histogram(draws[:, 0], bins=grid, density=True)
    ys = np.linspace(LOWS[1], HIGHS[1], 401)
    mids = 0.5 * (grid[1:] + grid[:-1])
    pts = torch.as_tensor([[m, y] for m in mids for y in ys], dtype=torch.float64)
    dens = np.exp(mix.log_pdf(pts).numpy()).reshape(len(mids), len(ys))
    marginal = np.trapezoid(dens, ys, axis=1) if hasattr(np, "trapezoid") else np.trapz(dens, ys, axis=1)
    np.testing.assert_allclose(hist, marginal, rtol=0.05, atol=0.005)


def test_mlp_reference_agrees_with_the_port_trainer():
    from optuna_tpu_torch.models.mlp import MLPParams, train_scaled_batch

    g = torch.Generator().manual_seed(3)
    x = torch.rand((512, 784), generator=g)
    labels = torch.randint(0, 10, (512,), generator=g)
    base = MLPParams(torch.randn(784, 32, generator=g) * 0.1, torch.zeros(32), torch.randn(32, 10, generator=g) * 0.1, torch.zeros(10))
    lr = torch.tensor([1e-3, 0.05, 0.4, 1.0])
    scale = torch.tensor([0.3, 1.0, 2.0, 3.0])
    port = train_scaled_batch(base, x, labels, lr, scale, 10)
    for i in range(4):
        ref = train_one(base._asdict(), x, labels, float(lr[i]), float(scale[i]), 10)
        assert float(port[i]) == pytest.approx(ref, rel=1e-5)
