"""The WFG node kernel, the WFG stack machine and the routed hypervolume
functions of the port against the reference, on the CPU.

* ``limit_and_filter_plain`` (what the wrapper runs for CPU tensors) equals
  the reference's XLA twin and its Pallas kernel in interpret mode exactly:
  max, compares and selects only.
* ``hypervolume_wfg`` runs the same node sequence as the reference's
  ``lax.while_loop`` in the same float32 operations: rel 1e-6 against the
  XLA twin, and the reference's own bar, rel 5e-4, against the host f64
  oracle.
* The routed functions are held to the reference's routed functions with
  the reference's tolerances (``tests/test_hypervolume.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from optuna_tpu import hypervolume as ref_hv
from optuna_tpu.hypervolume.wfg import _compute_hv_recursive
from optuna_tpu.hypervolume.wfg import _pareto_filter as ref_pareto_filter
from optuna_tpu.hypervolume.wfg import compute_hypervolume as host_hv
from optuna_tpu.ops import wfg as ref_wfg
from optuna_tpu.ops.pallas.wfg import limit_and_filter as ref_limit_and_filter
from optuna_tpu_torch import hypervolume
from optuna_tpu_torch.hypervolume import wfg as port_host_wfg
from optuna_tpu_torch.ops import hypervolume as port_ops_hv
from optuna_tpu_torch.ops import wfg
from optuna_tpu_torch.ops.kernels import wfg as kwfg
from tests._torch_port import cuda_device, np64, t32  # noqa: F401


def _frame(n, m, seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1, size=(n, m)).astype(np.float32)
    pts[1] = pts[0]  # a duplicate: the lower index survives
    pts[n // 2] = np.maximum(pts[n // 2 - 1], 0.9)  # dominated after clamping
    p = rng.uniform(0, 0.6, size=m).astype(np.float32)
    eligible = rng.uniform(size=n) < 0.8
    ref = np.full(m, 1.5, np.float32)
    return pts, p, eligible, ref


def _port_frame(pts, p, eligible, ref, device="cpu"):
    return (
        torch.as_tensor(pts, device=device), torch.as_tensor(p, device=device),
        torch.as_tensor(eligible, device=device), torch.as_tensor(ref, device=device),
    )


@pytest.mark.parametrize("n,m", [(32, 5), (8, 6), (128, 5), (16, 2)])
def test_plain_limit_and_filter_equals_the_xla_twin(n, m):
    frame = _frame(n, m, seed=n * m)
    pts_p, msk_p = kwfg.limit_and_filter_plain(*_port_frame(*frame))
    pts_x, msk_x = ref_limit_and_filter(*frame, use_pallas=False)
    np.testing.assert_array_equal(msk_p.numpy(), np.asarray(msk_x))
    np.testing.assert_array_equal(pts_p.numpy(), np.asarray(pts_x))


@pytest.mark.parametrize("n,m", [(32, 5), (8, 6)])
def test_plain_limit_and_filter_equals_the_pallas_kernel_in_interpret_mode(n, m):
    frame = _frame(n, m, seed=n + m)
    pts_p, msk_p = kwfg.limit_and_filter_plain(*_port_frame(*frame))
    pts_k, msk_k = ref_limit_and_filter(*frame, use_pallas=True)
    np.testing.assert_array_equal(msk_p.numpy(), np.asarray(msk_k))
    np.testing.assert_array_equal(pts_p.numpy(), np.asarray(pts_k))


def test_wrapper_runs_the_plain_version_for_cpu_tensors_without_a_launch():
    frame = _port_frame(*_frame(16, 5, seed=1))
    before = kwfg.LAUNCHES
    got = kwfg.limit_and_filter(*frame)
    assert kwfg.LAUNCHES == before
    want = kwfg.limit_and_filter_plain(*frame)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _front(n, m, seed, extras=False):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1, size=(n, m))
    if extras:  # a duplicate, a dominated point and one outside the reference point
        pts[-3] = pts[0]
        pts[-2] = np.minimum(pts[1] + 0.05, 0.99)
        pts[-1] = np.full(m, 2.0)
    return pts


@pytest.mark.parametrize("n,m", [(16, 5), (64, 5), (16, 6), (40, 6)])
def test_hypervolume_wfg_equals_the_xla_twin_and_the_host_oracle(n, m):
    pts = _front(n, m, seed=10 * n + m, extras=True)
    ref = np.ones(m)
    got = wfg.hypervolume_wfg_nd(pts, ref, device="cpu")
    twin = ref_wfg.hypervolume_wfg_nd(pts, ref)
    oracle = host_hv(pts, ref)
    assert got == pytest.approx(twin, rel=1e-6)
    assert got == pytest.approx(oracle, rel=5e-4)


def test_hypervolume_wfg_body_is_inert_at_depth_zero_and_counts_syncs():
    pts = _front(16, 5, seed=3)
    wfg.reset_stats()
    got = wfg.hypervolume_wfg_nd(pts, np.ones(5), device="cpu")
    stats = dict(wfg.STATS)
    # Bodies run in whole chunks; the ones after the stack empties change nothing.
    assert stats["bodies"] == stats["syncs"] * wfg.NODES_PER_SYNC
    assert stats["bodies"] - wfg.NODES_PER_SYNC < stats["nodes"] <= stats["bodies"]
    assert got == pytest.approx(_compute_hv_recursive(pts, np.ones(5)), rel=5e-4)


def test_empty_and_single_point_fronts():
    ref = np.ones(5)
    assert wfg.hypervolume_wfg_nd(np.full((3, 5), 2.0), ref, device="cpu") == 0.0
    one = np.full((1, 5), 0.5)
    assert wfg.hypervolume_wfg_nd(one, ref, device="cpu") == pytest.approx(0.5**5, rel=1e-6)


@pytest.mark.parametrize("m", [5, 6])
def test_wfg_loo_contributions_equal_the_reference(m):
    rng = np.random.RandomState(200 + m)
    base = rng.uniform(0, 1, size=(18, m))
    pts = np.vstack([base, base[0], base[1] + 0.01])  # duplicate + dominated
    ref = np.ones(m)
    got = wfg.wfg_loo_nd(pts, ref, device="cpu")
    np.testing.assert_allclose(got, ref_wfg.wfg_loo_nd(pts, ref), rtol=1e-5, atol=1e-7)
    total = host_hv(pts, ref)
    want = np.array([max(total - host_hv(np.delete(pts, i, axis=0), ref), 0.0) for i in range(len(pts))])
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("n", [8, 33, 100])
def test_hypervolume_2d_contributions_equal_the_reference(n):
    from optuna_tpu.ops.hypervolume import hypervolume_2d, hypervolume_2d_contributions

    rng = np.random.RandomState(n)
    pts = rng.uniform(0, 1, size=(n, 2)).astype(np.float32)
    pts[1] = pts[0]
    pts[-1] = [1.5, 0.2]
    ref = np.ones(2, np.float32)
    got = port_ops_hv.hypervolume_2d_contributions(t32(pts), t32(ref))
    np.testing.assert_allclose(np64(got), np64(hypervolume_2d_contributions(pts, ref)), rtol=1e-5, atol=1e-7)
    assert float(port_ops_hv.hypervolume_2d(t32(pts), t32(ref))) == pytest.approx(
        float(hypervolume_2d(pts, ref)), rel=1e-6
    )


@pytest.mark.parametrize(
    "m,n,min_front", [(2, 40, None), (5, 36, None), (5, 36, 16), (5, 20, None), (2, 10, None), (3, 20, None)]
)
def test_routed_compute_hypervolume_equals_the_reference(monkeypatch, m, n, min_front):
    rng = np.random.RandomState(m * n)
    pts = rng.uniform(0, 10, size=(n, m))  # un-normalised magnitudes
    ref = np.full(m, 11.0)
    if min_front is not None:  # the front (25 points) takes the port's device route
        monkeypatch.setattr(hypervolume, "_DEVICE_MIN_FRONT_WFG", min_front)
    wfg.reset_stats()
    got = hypervolume.compute_hypervolume(pts, ref, device="cpu")
    assert (wfg.STATS["syncs"] > 0) == (min_front is not None)
    want = ref_hv.compute_hypervolume(pts, ref)
    assert got == pytest.approx(want, rel=5e-4 if min_front else 1e-12)


@pytest.mark.parametrize("m,n", [(2, 30), (2, 40), (5, 40), (5, 12)])
def test_routed_loo_contributions_equal_the_reference(m, n):
    rng = np.random.RandomState(9 + m + n)
    pts = rng.uniform(0, 10, size=(n, m))
    ref = np.full(m, 11.0)
    got = hypervolume.loo_contributions(pts, ref, device="cpu")
    want = ref_hv.loo_contributions(pts, ref)
    total = host_hv(pts, ref)
    np.testing.assert_allclose(got / total, want / total, atol=2e-3)


def test_routes_to_the_missing_slicing_engine_raise():
    rng = np.random.RandomState(0)
    with pytest.raises(NotImplementedError, match="A6"):
        hypervolume.compute_hypervolume(rng.uniform(0, 1, size=(80, 4)), np.ones(4), assume_pareto=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        hypervolume.loo_contributions(rng.uniform(0, 1, size=(64, 3)), np.ones(3), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        hypervolume.solve_hssp(rng.uniform(0, 1, size=(128, 3)), np.ones(3), 8, device="cpu")


def test_host_routes_need_no_device_and_match_the_reference():
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 1, size=(40, 3))
    ref = np.ones(3)
    # Below the M = 3 threshold, and the host HSSP below 128 points: no device.
    assert hypervolume.compute_hypervolume(pts, ref) == ref_hv.compute_hypervolume(pts, ref)
    np.testing.assert_array_equal(hypervolume.solve_hssp(pts, ref, 5), ref_hv.solve_hssp(pts, ref, 5))
    np.testing.assert_array_equal(port_host_wfg._pareto_filter(pts), ref_pareto_filter(pts))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(128, 5), (512, 5), (64, 6), (1024, 8), (16, 2)])
def test_kernel_equals_plain_on_the_card(cuda_device, n, m):  # noqa: F811
    frame = _port_frame(*_frame(n, m, seed=n * m), device=cuda_device)
    before = kwfg.LAUNCHES
    got = kwfg.limit_and_filter(*frame)
    torch.cuda.synchronize()
    assert kwfg.LAUNCHES == before + 1
    want = kwfg.limit_and_filter_plain(*frame)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_raises_outside_what_it_supports(cuda_device):  # noqa: F811
    with pytest.raises(ValueError, match="outside what the kernel supports"):
        kwfg.limit_and_filter(*_port_frame(*_frame(2048, 8, seed=0), device=cuda_device))
    with pytest.raises(ValueError, match="outside what the kernel supports"):
        kwfg.limit_and_filter(*_port_frame(*_frame(16, 17, seed=0), device=cuda_device))
