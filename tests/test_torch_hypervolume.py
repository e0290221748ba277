"""The port's N-D hypervolume slicing engine and device HSSP against the
reference, on the CPU (``optuna_tpu_torch/ops/hypervolume.py``).

* ``hypervolume_nd`` and ``hypervolume_loo_nd`` equal the reference's to
  ``REL`` (1e-5 relative; both sum float32 terms, in another order), and the
  host float64 oracle (``hypervolume/wfg.py``) to ``tests/test_hypervolume.py``'s
  bar (rtol 1e-4, atol 1e-6), at M = 3, 4 and 5 on uniform fronts, fronts on
  a sphere (all non-dominated), fronts with duplicates and fronts with
  points beyond the reference point.
* ``solve_hssp_device`` selects what the reference selects. The greedy takes
  the first maximum of float32 gains, which the two frameworks' sums can
  break apart at a near tie: a parting is allowed only where the two picks'
  float64 gains are within ``TIE`` of each other, and then ends the
  comparison. At M = 5 the scorer is the WFG stack (its plain version on the
  CPU), and the reference's HSSP stays at n <= 64, k <= 4: its vmapped
  while-loops are slow on the CPU.
* The three routes of ``optuna_tpu_torch.hypervolume`` that raised before
  the engine was ported compute what the reference's do, above each
  threshold.
* MOTPE (``TPESampler`` on three and five objectives) runs trial for trial
  with the reference's draws past its first device HSSP, from a prefilled
  history of 128 non-dominated trials.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu import hypervolume as ref_routed
from optuna_tpu.hypervolume.wfg import _compute_hv_recursive
from optuna_tpu.hypervolume.wfg import compute_hypervolume as host_hv
from optuna_tpu.ops import hypervolume as ref_ops
from optuna_tpu_torch import hypervolume as port_routed
from optuna_tpu_torch.hypervolume.hssp import solve_hssp as port_host_hssp
from optuna_tpu_torch.ops import hypervolume as port_ops
from optuna_tpu_torch.ops import wfg as port_wfg
from optuna_tpu_torch.ops.kernels import wfg as kwfg
from optuna_tpu_torch.samplers._tpe import sampler as port_tpe
from tests._torch_port import cuda_device, reference_tpe_draws  # noqa: F401
from tests.test_torch_tpe import assert_same_study, port_scores  # noqa: F401

REL = 1e-5  # port against the reference: float32 sums in another order
F64_RTOL, F64_ATOL = 1e-4, 1e-6  # tests/test_hypervolume.py's bar against the f64 oracle
TIE = 1e-5  # gap of two float64 greedy gains, over the selection's hypervolume, that counts as a near tie
CPU = "cpu"

optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)
optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)


def _front(kind: str, n: int, m: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    ref = np.ones(m)
    if kind == "sphere":  # every point non-dominated
        raw = np.abs(rng.normal(size=(n, m))) + 1e-3
        return 1.0 - 0.9 * raw / np.linalg.norm(raw, axis=1, keepdims=True), ref
    pts = rng.uniform(0.0, 1.0, size=(n, m))
    if kind == "duplicates":
        pts[n // 2 :] = pts[: n - n // 2]
    elif kind == "outside":
        pts[::5] += 0.6  # some beyond the reference point
    return pts, ref


KINDS = ["uniform", "sphere", "duplicates", "outside"]
# (M, n): the slicing engine's cost grows as n^(M-1), so M = 5 stays small.
SIZES = [(3, 64), (3, 100), (4, 48), (5, 24)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n", SIZES)
def test_hypervolume_nd_equals_the_reference_and_the_f64_oracle(m, n, kind):
    pts, ref = _front(kind, n, m, seed=10 * m + n)
    got = port_ops.hypervolume_nd(pts, ref, device=CPU)
    assert got == pytest.approx(ref_ops.hypervolume_nd(pts, ref), rel=REL)
    np.testing.assert_allclose(got, host_hv(pts, ref), rtol=F64_RTOL, atol=F64_ATOL)


@pytest.mark.parametrize(
    "m,n,kind", [(3, 40, k) for k in KINDS] + [(4, 24, k) for k in KINDS] + [(5, 12, "outside")]
)
def test_hypervolume_loo_nd_equals_the_reference_and_the_f64_oracle(m, n, kind):
    pts, ref = _front(kind, n, m, seed=7 * m + n)
    got = port_ops.hypervolume_loo_nd(pts, ref, device=CPU)
    want = ref_ops.hypervolume_loo_nd(pts, ref)
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-7)
    total = host_hv(pts, ref)
    oracle = np.array([max(total - host_hv(np.delete(pts, i, axis=0), ref), 0.0) for i in range(n)])
    np.testing.assert_allclose(got, oracle, rtol=F64_RTOL, atol=F64_ATOL)
    if kind == "duplicates":
        assert np.all(got == 0.0)  # every point has a twin


def test_a_chunked_level_equals_one_chunk(monkeypatch):
    """The levels above M = 3 loop over chunks of prefixes; the chunking
    (and the split of a large batch of frames) changes no bit."""
    pts, ref = _front("uniform", 20, 4, seed=3)
    one = port_ops.hypervolume_loo_nd(pts, ref, device=CPU)
    monkeypatch.setattr(port_ops, "_SLICE_ELEMENTS", 3 * 32 * 32)
    np.testing.assert_array_equal(port_ops.hypervolume_loo_nd(pts, ref, device=CPU), one)


def _greedy_gain(pts: np.ndarray, ref: np.ndarray, chosen, i: int) -> float:
    base = _compute_hv_recursive(pts[list(chosen)], ref) if len(chosen) else 0.0
    return _compute_hv_recursive(pts[list(chosen) + [i]], ref) - base


def assert_same_selection(got: np.ndarray, want: np.ndarray, pts: np.ndarray, ref: np.ndarray) -> None:
    """Equal selections, or equal up to a step where the two picks are a
    near tie in float64 gain (and nothing is compared after it). The gains
    are float32 differences of hypervolumes, so their noise scales with the
    selection's hypervolume: that is the scale of the tie."""
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gains = [_greedy_gain(pts, ref, want[:step], i) for i in (g, w)]
            scale = _compute_hv_recursive(pts[list(want[: step + 1])], ref)
            assert abs(gains[0] - gains[1]) <= TIE * scale, (step, g, w, gains, scale)
            return


@pytest.mark.parametrize("kind", ["uniform", "sphere", "duplicates"])
@pytest.mark.parametrize("m,n,k", [(3, 64, 8), (3, 40, 16), (4, 48, 6), (5, 40, 4), (5, 64, 3)])
def test_solve_hssp_device_equals_the_reference(m, n, k, kind):
    pts, ref = _front(kind, n, m, seed=m * n + k)
    port_wfg.reset_stats()
    got = port_ops.solve_hssp_device(pts, ref, k, device=CPU)
    assert (port_wfg.STATS["syncs"] > 0) == (m >= port_ops.WFG_MIN_OBJECTIVES)
    want = ref_ops.solve_hssp_device(pts, ref, k)
    assert got.dtype == np.int64 and len(set(got.tolist())) == k
    assert_same_selection(got, want, pts, ref)


def test_solve_hssp_device_edge_sizes():
    pts, ref = _front("uniform", 10, 3, seed=0)
    assert port_ops.solve_hssp_device(pts, ref, 0, device=CPU).tolist() == []
    assert port_ops.solve_hssp_device(pts, ref, 10, device=CPU).tolist() == list(range(10))
    assert port_ops.solve_hssp_device(pts, ref, 12, device=CPU).tolist() == list(range(10))


# --------------------------------------------- the WFG_MIN_OBJECTIVES boundary


def _noisy_sphere(n: int, m: int, seed: int) -> np.ndarray:
    """``tests/test_hypervolume_boundary.py``'s front: mostly non-dominated
    with a few dominated stragglers."""
    rng = np.random.RandomState(seed)
    raw = rng.uniform(0.1, 1.0, size=(n, m))
    pts = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    pts += rng.uniform(0.0, 0.05, size=(n, m))
    return pts.astype(np.float32)


def test_boundary_is_the_reference_constant():
    assert port_ops.WFG_MIN_OBJECTIVES == ref_ops.WFG_MIN_OBJECTIVES == 5


@pytest.mark.parametrize("m", [4, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_way_parity_across_the_boundary(m, seed):
    """Slicing, the WFG stack and the host oracle agree at M = 4 and M = 5,
    as in the reference's boundary test (rel 2e-4 against f64)."""
    pts = _noisy_sphere(12, m, seed)
    ref = np.full(m, 1.3, np.float32)
    padded, mask = port_ops._padded(pts, ref, torch.device(CPU))
    ref_t = torch.as_tensor(ref)
    hv_slice = float(port_ops.hypervolume_masked(padded, ref_t, mask))
    hv_wfg = float(port_wfg.hypervolume_wfg(padded, ref_t, mask))
    hv_host = _compute_hv_recursive(pts.astype(np.float64), ref.astype(np.float64))
    assert hv_slice == pytest.approx(hv_host, rel=2e-4)
    assert hv_wfg == pytest.approx(hv_host, rel=2e-4)
    assert hv_slice == pytest.approx(hv_wfg, rel=2e-4)
    ref_padded, ref_mask = ref_ops._padded(pts, ref)
    assert hv_slice == pytest.approx(float(ref_ops.hypervolume_masked(ref_padded, jnp.asarray(ref), ref_mask)), rel=REL)


@pytest.mark.parametrize("m", [4, 5])
def test_hssp_selection_is_scorer_invariant_at_the_boundary(m):
    pts = _noisy_sphere(10, m, seed=7)
    ref = np.full(m, 1.3, np.float32)
    padded, mask = port_ops._padded(pts, ref, torch.device(CPU))
    picks = {
        use_wfg: port_ops._hssp_greedy(padded, torch.as_tensor(ref), mask, 4, 4, use_wfg=use_wfg).numpy()[:4]
        for use_wfg in (False, True)
    }
    np.testing.assert_array_equal(picks[False], picks[True])
    routed = port_ops.solve_hssp_device(pts, ref, 4, device=CPU)
    np.testing.assert_array_equal(routed, picks[m >= port_ops.WFG_MIN_OBJECTIVES])
    np.testing.assert_array_equal(routed, ref_ops.solve_hssp_device(pts, ref, 4))


# -------------------------------------------------- the routes that raised


@pytest.mark.parametrize("m,n", [(3, 1100), (4, 80)])
def test_routed_compute_hypervolume_above_the_threshold_equals_the_reference(m, n):
    pts, ref = _front("sphere", n, m, seed=m)
    pts, ref = pts * 10.0, ref * 10.0  # un-normalised magnitudes
    got = port_routed.compute_hypervolume(pts, ref, assume_pareto=True, device=CPU)
    assert got == pytest.approx(ref_routed.compute_hypervolume(pts, ref, assume_pareto=True), rel=REL)
    assert got == pytest.approx(host_hv(pts, ref, assume_pareto=True), rel=F64_RTOL)


@pytest.mark.parametrize("m,n", [(3, 64), (4, 64), (3, 90)])
def test_routed_loo_contributions_above_the_threshold_equal_the_reference(m, n):
    pts, ref = _front("outside", n, m, seed=n + m)
    pts, ref = pts * 5.0, ref * 5.0
    got = port_routed.loo_contributions(pts, ref, device=CPU)
    want = ref_routed.loo_contributions(pts, ref)
    total = host_hv(pts, ref)
    np.testing.assert_allclose(got / total, want / total, atol=REL)


@pytest.mark.parametrize("m,n,k", [(3, 128, 8), (4, 130, 5), (3, 200, 16)])
def test_routed_solve_hssp_above_the_threshold_equals_the_reference(m, n, k):
    pts, ref = _front("uniform", n, m, seed=n + k)
    pts, ref = pts * 3.0 - 1.0, ref * 3.0  # the route normalises: the same picks
    got = port_routed.solve_hssp(pts, ref, k, device=CPU)
    want = ref_routed.solve_hssp(pts, ref, k)
    assert_same_selection(got, want, pts, ref)


def test_routed_solve_hssp_at_five_objectives_equals_the_host_greedy():
    """At M = 5 the route scores through the WFG stack; the reference's
    device HSSP is too slow on the CPU at 128 points, so the port is held
    to the host lazy greedy, which selects what a plain greedy selects."""
    pts, ref = _front("uniform", 128, 5, seed=5)
    port_wfg.reset_stats()
    got = port_routed.solve_hssp(pts, ref, 3, device=CPU)
    assert port_wfg.STATS["syncs"] > 0  # the device route ran
    assert_same_selection(got, port_host_hssp(pts, ref, 3), pts, ref)


def test_the_device_routes_resolve_the_card_and_never_fall_back():
    pts, ref = _front("uniform", 128, 3, seed=0)
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is taken")
    for call in (
        lambda: port_routed.solve_hssp(pts, ref, 4),
        lambda: port_routed.loo_contributions(pts[:64], ref),
        lambda: port_routed.compute_hypervolume(_front("sphere", 80, 4, 0)[0], np.ones(4), assume_pareto=True),
    ):
        with pytest.raises(RuntimeError, match="no GPU"):
            call()


# ------------------------------------------------------------ MOTPE at M >= 3


def _simplex(m: int):
    """A linear front: objectives ``x_0 .. x_{m-2}`` and ``-sum(x)``. Every
    trial is non-dominated, so the first rank holds every complete trial and
    the split's HSSP takes the device route from 128 trials on."""

    def objective(trial):
        xs = [trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(m - 1)]
        return (*xs, -sum(xs))

    return objective


def _below(n: int) -> int:
    """MOTPE's below count, the default's up to 4: the reference's device
    HSSP at M = 5 is slow on the CPU at larger subsets."""
    return min(int(np.ceil(0.1 * n)), 4)


def _prefilled(mod, m: int, n: int, **sampler_kwargs):
    """A MOTPE study holding ``n`` seeded COMPLETE trials of ``_simplex(m)``,
    the same in both packages: its next asks split through the device HSSP."""
    sampler = mod.samplers.TPESampler(seed=0, gamma=_below, **sampler_kwargs)
    study = mod.create_study(directions=["minimize"] * m, sampler=sampler)
    rng = np.random.RandomState(m)
    dist = mod.distributions.FloatDistribution(0.0, 1.0)
    for _ in range(n):
        xs = rng.uniform(size=m - 1)
        study.add_trial(mod.trial.create_trial(
            params={f"x{i}": float(x) for i, x in enumerate(xs)}, distributions={f"x{i}": dist for i in range(m - 1)},
            values=[*map(float, xs), -float(xs.sum())],
        ))
    return study


def _spy(monkeypatch, module, calls):
    real = module.solve_hssp_device

    def spy(points, reference_point, subset_size, **kw):
        out = real(points, reference_point, subset_size, **kw)
        calls.append((np.array(points), np.array(reference_point), np.asarray(out)))
        return out

    monkeypatch.setattr(module, "solve_hssp_device", spy)


@pytest.mark.usefixtures("reference_tpe_draws")
@pytest.mark.parametrize("m,n_asks", [(3, 6), (5, 2)])
def test_motpe_matches_reference_past_the_device_hssp(monkeypatch, port_scores, m, n_asks):  # noqa: F811
    """From a prefilled history of 128 non-dominated trials, every ask's split
    runs the device HSSP in both packages (at M = 5 through the WFG stack,
    the plain loop on the CPU): the same selections, then the same trials."""
    ref_calls, port_calls = [], []
    _spy(monkeypatch, ref_ops, ref_calls)
    _spy(monkeypatch, port_ops, port_calls)
    ref_study = _prefilled(optuna_tpu, m, 128)
    port_study = _prefilled(optuna_tpu_torch, m, 128, device=CPU)
    port_wfg.reset_stats()
    ref_study.optimize(_simplex(m), n_trials=n_asks)
    port_study.optimize(_simplex(m), n_trials=n_asks)
    assert (port_wfg.STATS["syncs"] > 0) == (m >= port_ops.WFG_MIN_OBJECTIVES)
    assert len(port_calls) == n_asks and len(port_calls[0][0]) == 128
    for (pts, ref, got), (ref_pts, _, want) in zip(port_calls, ref_calls):
        if not np.array_equal(pts, ref_pts):
            break  # the histories parted at a near tie, checked below
        assert_same_selection(got, want, pts, ref)
        if not np.array_equal(got, want):
            break
    assert assert_same_study(ref_study, port_study, port_scores, n_startup=128) is None or m == 3


# ------------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(5, 512, 16), (5, 100, 7), (3, 256, 16), (4, 128, 8)])
def test_device_hssp_on_the_card_equals_the_cpu(cuda_device, m, n, k):  # noqa: F811
    """The HSSP on the card (K3 at M = 5, one launch a step) against the same
    greedy on the CPU (the plain stack): the same picks, or a near tie."""
    pts, ref = _front("uniform", n, m, seed=n)
    before = kwfg.STACK_LAUNCHES
    got = port_ops.solve_hssp_device(pts, ref, k, device=cuda_device)
    torch.cuda.synchronize()
    assert kwfg.STACK_LAUNCHES - before == (k if m >= 5 else 0)
    assert_same_selection(got, port_ops.solve_hssp_device(pts, ref, k, device=CPU), pts, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k_pad", [4, 16])
def test_stack_kernel_equals_plain_at_the_hssp_shapes_on_the_card(cuda_device, k_pad):  # noqa: F811
    """K3 on a greedy step's batch of candidate roots (512, k_pad + 1, 5),
    with a selection of ``k_pad`` points already made: the same bits and
    node counts as the plain stack loop on the card."""
    pts, ref = _front("uniform", 512, 5, seed=k_pad)
    points = torch.as_tensor(pts, dtype=torch.float32, device=cuda_device)
    ref_t = torch.ones(5, device=cuda_device)
    sel = points[:k_pad]
    cand = torch.cat([sel[None].expand(512, k_pad, 5), points[:, None, :]], dim=1)
    roots = port_wfg._roots(cand, ref_t, torch.ones(cand.shape[:2], dtype=torch.bool, device=cuda_device))
    before = kwfg.STACK_LAUNCHES
    acc, nodes = kwfg.wfg_stack(*roots, ref_t)
    assert kwfg.STACK_LAUNCHES == before + 1
    plain_acc, plain_nodes = kwfg.wfg_stack_plain(*roots, ref_t)
    assert torch.equal(acc, plain_acc) and torch.equal(nodes, plain_nodes)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(3, 1500), (4, 256)])
def test_slicing_engine_on_the_card_equals_the_cpu(cuda_device, m, n):  # noqa: F811
    pts, ref = _front("sphere", n, m, seed=n)
    got = port_ops.hypervolume_nd(pts, ref, device=cuda_device)
    assert got == pytest.approx(port_ops.hypervolume_nd(pts, ref, device=CPU), rel=REL)
    assert got == pytest.approx(host_hv(pts, ref, assume_pareto=True), rel=F64_RTOL)
