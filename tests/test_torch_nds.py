"""The NSGA-II dominance kernel and the non-domination ranking of the port
against the reference.

``dominance_matrix_plain`` (what the wrapper runs for CPU tensors) is held
against the reference's broadcast branch and, at one 128-tile, its Pallas
kernel in interpret mode. Everything here is compares on exact inputs, so
every check is equality. Reference ranks for large pools are computed with
``use_pallas=False`` (the Pallas interpreter is orders of magnitude slower
on the CPU, ROADMAP C3).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import optuna_tpu.ops.pareto as ref_pareto
from optuna_tpu.ops.pallas.nds import dominance_matrix as ref_dominance_matrix
from optuna_tpu.study._multi_objective import _fast_non_domination_rank as ref_rank
from optuna_tpu_torch.ops import pareto
from optuna_tpu_torch.ops.kernels import nds
from optuna_tpu_torch.study import _multi_objective
from tests._torch_port import cuda_device, t32  # noqa: F401


def _ordinals_with_ties(n, m, seed, n_pad=None):
    """Small-integer ordinals with ties and duplicate rows, padded rows at
    ``n_pad + 1`` as ``non_domination_rank_np`` pads them."""
    rng = np.random.RandomState(seed)
    v = rng.randint(0, max(2, n // 8), size=(n, m)).astype(np.float32)
    v[1::7] = v[0::7][: len(v[1::7])]  # duplicate rows
    n_pad = n_pad or n
    out = np.full((n_pad, m), np.float32(n_pad + 1), np.float32)
    out[:n] = v
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    return out, mask


@pytest.mark.parametrize("n,m", [(128, 2), (100, 3), (256, 5), (40, 1)])
def test_plain_dominance_equals_the_reference_broadcast(n, m):
    v, _ = _ordinals_with_ties(n, m, seed=n + m)
    port = nds.dominance_matrix_plain(t32(v))
    ref = ref_dominance_matrix(v, use_pallas=False)
    assert port.dtype == torch.float32 and port.shape == (n, n)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_plain_dominance_equals_the_pallas_kernel_at_one_tile():
    v, _ = _ordinals_with_ties(nds.TILE, 3, seed=11)
    ref = ref_dominance_matrix(v, use_pallas=True)
    np.testing.assert_array_equal(nds.dominance_matrix_plain(t32(v)).numpy(), np.asarray(ref))


def test_wrapper_runs_the_plain_version_for_cpu_tensors_without_a_launch():
    v = t32(_ordinals_with_ties(64, 2, seed=3)[0])
    before = nds.LAUNCHES
    out = nds.dominance_matrix(v)
    assert nds.LAUNCHES == before
    assert torch.equal(out, nds.dominance_matrix_plain(v))


@pytest.mark.parametrize("n,n_pad,m", [(128, 128, 2), (600, 640, 3), (300, 384, 5)])
def test_non_domination_rank_equals_the_reference(n, n_pad, m):
    v, mask = _ordinals_with_ties(n, m, seed=n_pad + m, n_pad=n_pad)
    port = pareto.non_domination_rank(t32(v), t32(mask))
    ref = ref_pareto.non_domination_rank(v, mask, use_pallas=False)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert int(port[:n].max()) > 1  # several fronts were peeled


def test_non_domination_rank_np_ranks_raw_floats_like_the_host_sort():
    rng = np.random.RandomState(4)
    values = rng.uniform(0, 1, size=(200, 2))
    values[::9] = values[1::9][: len(values[::9])]
    values[5] = [np.inf, 0.0]
    got = pareto.non_domination_rank_np(values, device="cpu")
    want = _multi_objective._fast_non_domination_rank(values)  # host route below 512
    np.testing.assert_array_equal(got, want)


def _pool(n, m, seed, with_penalty):
    rng = np.random.RandomState(seed)
    values = rng.randint(0, 40, size=(n, m)).astype(np.float64) + rng.uniform(0, 1e-3, size=(n, m))
    values[3::17] = values[2::17][: len(values[3::17])]  # duplicates
    values[::53, 1] = np.nan
    penalty = None
    if with_penalty:
        penalty = np.where(rng.uniform(size=n) < 0.1, rng.uniform(0, 3, size=n), 0.0)
        penalty[7::31] = np.nan
        penalty[11::29] = penalty[13::29][: len(penalty[11::29])]  # tied violations
    return values, penalty


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("n_below", [None, 64])
def test_fast_non_domination_rank_device_branch_equals_the_reference(monkeypatch, with_penalty, n_below):
    values, penalty = _pool(600, 3, seed=5, with_penalty=with_penalty)
    assert np.sum(~np.isnan(values).any(axis=1)) >= 512  # the device branch in both
    monkeypatch.setattr(
        ref_pareto,
        "non_domination_rank",
        functools.partial(ref_pareto.non_domination_rank, use_pallas=False),
    )
    want = ref_rank(values, penalty=penalty, n_below=n_below)
    got = _multi_objective._fast_non_domination_rank(
        values, penalty=penalty, n_below=n_below, device="cpu"
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_penalty", [False, True])
def test_fast_non_domination_rank_host_branch_equals_the_reference(with_penalty):
    values, penalty = _pool(300, 2, seed=6, with_penalty=with_penalty)
    want = ref_rank(values, penalty=penalty, n_below=40)
    got = _multi_objective._fast_non_domination_rank(values, penalty=penalty, n_below=40)
    np.testing.assert_array_equal(got, want)


def test_host_branch_never_resolves_the_device():
    # On a machine with no card, device=None must not raise below the threshold.
    values, _ = _pool(100, 2, seed=8, with_penalty=False)
    _multi_objective._fast_non_domination_rank(values, device=None)


def test_dominates_matches_the_reference():
    from optuna_tpu.study._multi_objective import _dominates_values as ref_dominates_values

    rng = np.random.RandomState(9)
    for _ in range(200):
        v0, v1 = rng.randint(0, 3, size=(2, 3)).astype(float)
        if rng.uniform() < 0.1:
            v0[0] = np.nan
        if rng.uniform() < 0.1:
            v1[1] = np.nan
        assert _multi_objective._dominates_values(v0, v1) == ref_dominates_values(v0, v1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(512, 2), (640, 5), (128, 3), (1000, 2), (96, 40)])
def test_kernel_equals_plain_on_the_card(cuda_device, n, m):  # noqa: F811
    v, _ = _ordinals_with_ties(n, m, seed=n * m, n_pad=((n + 127) // 128) * 128)
    x = torch.as_tensor(v, device=cuda_device)
    before = nds.LAUNCHES
    out = nds.dominance_matrix(x)
    torch.cuda.synchronize()
    assert nds.LAUNCHES == before + 1
    assert torch.equal(out, nds.dominance_matrix_plain(x))
