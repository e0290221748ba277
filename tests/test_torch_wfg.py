"""The WFG node kernel, the WFG stack machine and the routed hypervolume
functions of the port against the reference, on the CPU.

* ``limit_and_filter_plain`` (what the wrapper runs for CPU tensors) equals
  the reference's XLA twin and its Pallas kernel in interpret mode exactly:
  max, compares and selects only.
* ``hypervolume_wfg`` runs the same node sequence as the reference's
  ``lax.while_loop`` in the same float32 operations: rel 1e-6 against the
  XLA twin, and the reference's own bar, rel 5e-4, against the host f64
  oracle.
* ``wfg_stack_plain`` (what ``wfg_stack`` runs for CPU tensors) gives each
  batch row the bits and node count of a separate hypervolume, and the
  batched leave-one-out equals the reference's.
* The routed functions are held to the reference's routed functions with
  the reference's tolerances (``tests/test_hypervolume.py``).
* Tests marked ``cuda`` hold both CUDA kernels to their plain versions on
  the card: the node step and the stack bit for bit, with equal node counts.
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
    """The three routes that raised ``NotImplementedError`` until the slicing
    engine and the device HSSP were ported now compute the reference's
    results (more cases in ``tests/test_torch_hypervolume.py``)."""
    rng = np.random.RandomState(0)
    raw = np.abs(rng.normal(size=(80, 4))) + 1e-3
    sphere = 1.0 - 0.9 * raw / np.linalg.norm(raw, axis=1, keepdims=True)  # 80 non-dominated points
    assert hypervolume.compute_hypervolume(sphere, np.ones(4), assume_pareto=True, device="cpu") == pytest.approx(
        ref_hv.compute_hypervolume(sphere, np.ones(4), assume_pareto=True), rel=1e-5
    )
    pts = rng.uniform(0, 1, size=(64, 3))
    total = host_hv(pts, np.ones(3))  # a contribution is a difference of totals: its f32 error scales with them
    np.testing.assert_allclose(
        hypervolume.loo_contributions(pts, np.ones(3), device="cpu") / total,
        ref_hv.loo_contributions(pts, np.ones(3)) / total, atol=1e-5,
    )
    pts = rng.uniform(0, 1, size=(128, 3))
    np.testing.assert_array_equal(
        hypervolume.solve_hssp(pts, np.ones(3), 8, device="cpu"), ref_hv.solve_hssp(pts, np.ones(3), 8)
    )


def test_host_routes_need_no_device_and_match_the_reference():
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 1, size=(40, 3))
    ref = np.ones(3)
    # Below the M = 3 threshold, and the host HSSP below 128 points: no device.
    assert hypervolume.compute_hypervolume(pts, ref) == ref_hv.compute_hypervolume(pts, ref)
    np.testing.assert_array_equal(hypervolume.solve_hssp(pts, ref, 5), ref_hv.solve_hssp(pts, ref, 5))
    np.testing.assert_array_equal(port_host_wfg._pareto_filter(pts), ref_pareto_filter(pts))


@pytest.mark.cuda
@pytest.mark.parametrize(
    # Past 16 objectives and 48 KB of frame: (2048, 8), (16, 17), (2048, 6);
    # (4096, 17) takes the global working-space path.
    "n,m", [(128, 5), (512, 5), (64, 6), (1024, 8), (16, 2), (2048, 8), (16, 17), (2048, 6), (4096, 17)]
)
def test_kernel_equals_plain_on_the_card(cuda_device, n, m):  # noqa: F811
    frame = _port_frame(*_frame(n, m, seed=n * m), device=cuda_device)
    before = kwfg.LAUNCHES
    got = kwfg.limit_and_filter(*frame)
    torch.cuda.synchronize()
    assert kwfg.LAUNCHES == before + 1
    want = kwfg.limit_and_filter_plain(*frame)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])




def _batch_roots(fronts, m, n_pad, device="cpu"):
    """Sorted root frames of several fronts, each padded to ``n_pad`` rows at
    the reference point ``ones(m)``, as ``wfg._padded`` pads one."""
    pts = np.ones((len(fronts), n_pad, m), np.float32)
    mask = np.zeros((len(fronts), n_pad), bool)
    for b, front in enumerate(fronts):
        pts[b, : len(front)] = front
        mask[b, : len(front)] = True
    ref = torch.ones(m, device=device)
    pts0, m0 = wfg._roots(torch.as_tensor(pts, device=device), ref, torch.as_tensor(mask, device=device))
    return pts0, m0, ref


@pytest.mark.parametrize("m", [5, 6])
@pytest.mark.parametrize("b", [1, 5])
def test_wfg_stack_plain_batch_rows_equal_separate_hypervolumes(b, m):
    rng = np.random.RandomState(10 * b + m)
    fronts = [rng.uniform(0, 1, size=(int(rng.randint(3, 15)), m)) for _ in range(b)]
    pts0, m0, ref = _batch_roots(fronts, m, 16)
    wfg.reset_stats()
    acc, nodes = kwfg.wfg_stack_plain(pts0, m0, ref)
    assert acc.shape == (b,) and nodes.shape == (b,)
    assert wfg.STATS["nodes"] == int(nodes.sum())
    for i, front in enumerate(fronts):
        wfg.reset_stats()
        assert float(acc[i]) == wfg.hypervolume_wfg_nd(front, np.ones(m), device="cpu")
        assert int(nodes[i]) == wfg.STATS["nodes"]


@pytest.mark.parametrize("n_pad", [32, 64])
def test_wfg_stack_plain_is_independent_of_the_padding(n_pad):
    # The roots put the masked rows first, so a wider bucket runs the same
    # nodes on the same rows: the card's global working-space path is
    # checked against a narrow bucket on this basis.
    front = np.random.RandomState(4).uniform(0, 1, size=(9, 6))
    acc16, nodes16 = kwfg.wfg_stack_plain(*_batch_roots([front], 6, 16))
    acc, nodes = kwfg.wfg_stack_plain(*_batch_roots([front], 6, n_pad))
    assert torch.equal(acc, acc16) and torch.equal(nodes, nodes16)


def test_stack_wrapper_runs_the_plain_version_for_cpu_tensors_without_a_launch():
    roots = _batch_roots([np.random.RandomState(2).uniform(0, 1, size=(6, 5))], 5, 16)
    before = kwfg.STACK_LAUNCHES
    got = kwfg.wfg_stack(*roots)
    assert kwfg.STACK_LAUNCHES == before
    want = kwfg.wfg_stack_plain(*roots)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,m", [(12, 5), (20, 6), (24, 5)])
def test_batched_loo_equals_the_reference_with_a_duplicate_a_dominated_and_an_outside_point(n, m):
    pts = _front(n, m, seed=300 + n + m, extras=True)
    ref = np.ones(m)
    got = wfg.wfg_loo_nd(pts, ref, device="cpu")
    np.testing.assert_allclose(got, ref_wfg.wfg_loo_nd(pts, ref), rtol=1e-5, atol=1e-7)
    total = host_hv(pts, ref)
    want = np.array([max(total - host_hv(np.delete(pts, i, axis=0), ref), 0.0) for i in range(len(pts))])
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)
    assert got[0] == 0.0 and np.all(got[-3:] == 0.0)  # the duplicate pair, the dominated, the outside


def test_batched_loo_rows_equal_separate_hypervolumes_bit_for_bit():
    pts, mask = wfg._padded(_front(14, 5, seed=7, extras=True), np.ones(5), torch.device("cpu"))
    ref = torch.ones(5)
    got = wfg.wfg_loo_contributions(pts, ref, mask)
    inside = mask & torch.all(pts < ref, dim=1)
    front = wfg._masked_pareto(pts, inside)
    idx = torch.arange(len(pts))
    for i in range(len(pts)):
        if not front[i]:
            assert float(got[i]) == 0.0
            continue
        covered = wfg.hypervolume_wfg(torch.maximum(pts, pts[i]), ref, inside & (idx != i))
        assert torch.equal(got[i], torch.clamp(kwfg._prod_last(ref - pts[i]) - covered, min=0.0))


@pytest.mark.parametrize("rows_per_step", [1, 3])
def test_roots_in_several_prelude_steps_equal_one_step(monkeypatch, rows_per_step):
    # The leave-one-out's limited frames as wfg_loo_contributions builds them.
    pts, mask = wfg._padded(_front(20, 5, seed=8, extras=True), np.ones(5), torch.device("cpu"))
    ref = torch.ones(5)
    n, m = pts.shape
    idx = torch.arange(n)
    limited = torch.maximum(pts[None, :, :], pts[:, None, :])
    lmask = mask[None, :] & (idx[None, :] != idx[:, None])
    one = wfg._roots(limited, ref, lmask)
    monkeypatch.setattr(wfg, "_PRELUDE_ELEMENTS", rows_per_step * n * n * m)
    steps = wfg._roots(limited, ref, lmask)
    assert torch.equal(steps[0], one[0]) and torch.equal(steps[1], one[1])
    assert steps[0].is_contiguous() and steps[1].is_contiguous()


def test_seventeen_objectives_on_the_cpu_equal_the_reference_and_the_host_oracle():
    pts = np.random.RandomState(1).uniform(0, 1, size=(16, 17))
    ref = np.ones(17)
    got = wfg.hypervolume_wfg_nd(pts, ref, device="cpu")
    assert got == pytest.approx(ref_wfg.hypervolume_wfg_nd(pts, ref), rel=1e-6)
    assert got == pytest.approx(host_hv(pts, ref), rel=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(16, 5), (64, 5), (40, 6), (20, 17)])
def test_stack_kernel_equals_plain_on_the_card(cuda_device, n, m):  # noqa: F811
    pts = _front(n, m, seed=n + m, extras=True)
    P, M = wfg._padded(pts, np.ones(m), cuda_device)
    ref = torch.ones(m, device=cuda_device)
    pts0, m0 = wfg._roots(P[None], ref, M[None])
    before, node_before = kwfg.STACK_LAUNCHES, kwfg.LAUNCHES
    acc, nodes = kwfg.wfg_stack(pts0, m0, ref)
    torch.cuda.synchronize()
    assert kwfg.STACK_LAUNCHES == before + 1 and kwfg.LAUNCHES == node_before
    want_acc, want_nodes = kwfg.wfg_stack_plain(pts0, m0, ref)
    assert torch.equal(acc, want_acc) and torch.equal(nodes, want_nodes)

    P, M = wfg._padded(pts[:12], np.ones(m), cuda_device)
    before = kwfg.STACK_LAUNCHES
    loo = wfg.wfg_loo_contributions(P, ref, M)
    torch.cuda.synchronize()
    assert kwfg.STACK_LAUNCHES == before + 1
    assert torch.equal(loo.cpu(), wfg.wfg_loo_contributions(P.cpu(), ref.cpu(), M.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks_per_launch", [1, 3])
def test_stack_kernel_split_over_launches_equals_one_launch(monkeypatch, cuda_device, blocks_per_launch):  # noqa: F811
    rng = np.random.RandomState(11)
    fronts = [rng.uniform(0, 1, size=(int(rng.randint(3, 15)), 5)) for _ in range(7)]
    roots = _batch_roots(fronts, 5, 16, device=cuda_device)
    one = kwfg.wfg_stack(*roots)
    pts, mask = wfg._padded(_front(14, 5, seed=12, extras=True), np.ones(5), cuda_device)
    loo_one = wfg.wfg_loo_contributions(pts, roots[2], mask)
    torch.cuda.synchronize()

    per_block = int(kwfg._library().wfg_stack_scratch_bytes(16, 5))
    monkeypatch.setattr(kwfg, "MAX_SCRATCH_BYTES", blocks_per_launch * per_block)
    before = kwfg.STACK_LAUNCHES
    split = kwfg.wfg_stack(*roots)
    torch.cuda.synchronize()
    assert kwfg.STACK_LAUNCHES == before + -(-7 // blocks_per_launch)  # at least 3 launches
    assert torch.equal(split[0], one[0]) and torch.equal(split[1], one[1])
    before = kwfg.STACK_LAUNCHES
    loo_split = wfg.wfg_loo_contributions(pts, roots[2], mask)
    torch.cuda.synchronize()
    assert kwfg.STACK_LAUNCHES == before + -(-16 // blocks_per_launch)
    assert torch.equal(loo_split, loo_one)
    plain = kwfg.wfg_stack_plain(*(t.cpu() for t in roots))
    assert torch.equal(split[0].cpu(), plain[0]) and torch.equal(split[1].cpu(), plain[1])


@pytest.mark.cuda
def test_stack_kernel_global_working_space_equals_the_shared_memory_path(cuda_device):  # noqa: F811
    # At (2048, 17) the working frame exceeds the shared memory a block can
    # have; the kernel keeps it in global scratch instead.
    front = np.random.RandomState(5).uniform(0, 1, size=(8, 17))
    narrow = kwfg.wfg_stack(*_batch_roots([front], 17, 16, device=cuda_device))
    wide = kwfg.wfg_stack(*_batch_roots([front], 17, 2048, device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(narrow[0], wide[0]) and torch.equal(narrow[1], wide[1])
    plain = kwfg.wfg_stack_plain(*_batch_roots([front], 17, 16))
    assert torch.equal(narrow[0].cpu(), plain[0]) and torch.equal(narrow[1].cpu(), plain[1])


@pytest.mark.cuda
def test_hypervolume_at_seventeen_objectives_on_the_card(cuda_device):  # noqa: F811
    pts = np.random.RandomState(1).uniform(0, 1, size=(16, 17))
    ref = np.ones(17)
    got = wfg.hypervolume_wfg_nd(pts, ref, device=cuda_device)
    assert got == wfg.hypervolume_wfg_nd(pts, ref, device="cpu")
    assert got == pytest.approx(host_hv(pts, ref), rel=5e-4)
