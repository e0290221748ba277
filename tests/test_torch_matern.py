"""The Matérn-5/2 Gram of the port against the reference.

``matern52_gram_plain`` (what the wrapper runs for CPU tensors) is held
against the reference's XLA twin, ``matern52_gram(..., use_pallas=False)``,
and against a float64 numpy oracle. The Pallas body is not a reference: its
expanded-norm form is 1.2e-6 from f64 at (37, 23, 5).

Tolerance: atol 5e-7 against both. Values are O(scale) ≤ 2; the twin itself
is 2.2e-7 from f64, and two f32 sums of the same terms in different orders
stay within about twice that.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from optuna_tpu.ops.pallas.matern import matern52_gram as ref_matern52_gram
from optuna_tpu_torch.ops.kernels import matern
from tests._torch_port import cuda_device, np64, t32  # noqa: F401

ATOL = 5e-7


def _oracle(x1, x2, w, scale, cat):
    diff = x1[:, None, :].astype(np.float64) - x2[None, :, :]
    sq = np.where(cat, (diff != 0.0).astype(np.float64), diff * diff)
    d2 = np.sum(sq * w.astype(np.float64), axis=-1)
    d = np.sqrt(d2)
    return float(scale) * (1.0 + np.sqrt(5.0) * d + 5.0 / 3.0 * d2) * np.exp(-np.sqrt(5.0) * d)


def _inputs(n1, n2, d, n_cat, seed):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, 1, size=(n1, d)).astype(np.float32)
    x2 = rng.uniform(0, 1, size=(n2, d)).astype(np.float32)
    cat = np.zeros(d, dtype=bool)
    if n_cat:
        cat[-n_cat:] = True
        x1[:, cat] = rng.randint(0, 3, size=(n1, n_cat))
        x2[:, cat] = rng.randint(0, 3, size=(n2, n_cat))
        x2[: min(n1, n2) // 2, cat] = x1[: min(n1, n2) // 2, cat]  # exact categorical matches
    w = rng.uniform(0.1, 3.0, size=d).astype(np.float32)
    scale = np.float32(rng.uniform(0.5, 2.0))
    return x1, x2, w, scale, cat


CASES = [(37, 23, 5, 0), (128, 300, 20, 0), (40, 50, 8, 3)]


@pytest.mark.parametrize("n1,n2,d,n_cat", CASES)
def test_plain_matches_the_xla_twin_and_f64(n1, n2, d, n_cat):
    x1, x2, w, scale, cat = _inputs(n1, n2, d, n_cat, seed=n1 + n2 + d)
    port = matern.matern52_gram_plain(t32(x1), t32(x2), t32(w), t32(scale), t32(cat, torch.bool))
    twin = ref_matern52_gram(x1, x2, w, scale, cat, use_pallas=False, has_categorical=bool(n_cat))
    oracle = _oracle(x1, x2, w, scale, cat)
    assert port.shape == (n1, n2) and port.dtype == torch.float32
    np.testing.assert_allclose(np64(port), np64(twin), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np64(port), oracle, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n1,n2,d,n_cat", CASES)
def test_wrapper_runs_the_plain_version_for_cpu_tensors_without_a_launch(n1, n2, d, n_cat):
    args = [t32(a) for a in _inputs(n1, n2, d, n_cat, seed=7)]
    args[4] = args[4].to(torch.bool)
    before = matern.LAUNCHES
    out = matern.matern52_gram(*args)
    assert matern.LAUNCHES == before
    assert torch.equal(out, matern.matern52_gram_plain(*args))


def test_gram_diagonal_is_the_scale():
    x1, _, w, scale, cat = _inputs(16, 16, 6, 2, seed=3)
    out = matern.matern52_gram_plain(t32(x1), t32(x1), t32(w), t32(scale), t32(cat, torch.bool))
    np.testing.assert_allclose(np.diag(np64(out)), float(scale), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,d,n_cat", CASES + [(256, 4096, 20, 0)])
def test_kernel_matches_plain_and_f64_on_the_card(cuda_device, n1, n2, d, n_cat):  # noqa: F811
    x1, x2, w, scale, cat = _inputs(n1, n2, d, n_cat, seed=n1 + n2 + d)
    args = [torch.as_tensor(a).to(cuda_device) for a in (x1, x2, w, scale, cat)]
    before = matern.LAUNCHES
    out = matern.matern52_gram(*args)
    torch.cuda.synchronize()
    assert matern.LAUNCHES == before + 1
    plain = matern.matern52_gram_plain(*args)
    np.testing.assert_allclose(np64(out), np64(plain), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np64(out), _oracle(x1, x2, w, scale, cat), rtol=0, atol=1e-6)


def test_cat_mask_goes_to_the_kernel_as_a_view_of_its_bytes():
    cat = torch.tensor([False, True, True, False, True])
    as_bytes = matern.cat_bytes(cat)
    assert as_bytes.dtype == torch.uint8 and as_bytes.data_ptr() == cat.data_ptr()
    assert as_bytes.tolist() == [0, 1, 1, 0, 1]
    assert cat.dtype == torch.bool and cat.tolist() == [False, True, True, False, True]
    with pytest.raises(TypeError):
        matern.cat_bytes(cat.to(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n1,n2,d,n_cat,offset",
    [(37, 23, 5, 0, 0), (70, 301, 20, 0, 0), (50, 130, 33, 2, 0), (256, 4094, 20, 0, 1), (64, 99, 5, 1, 1)],
)
def test_kernel_at_ragged_dims_and_offset_views_on_the_card(cuda_device, n1, n2, d, n_cat, offset):  # noqa: F811
    # d = 5 is never float4-aligned, d = 20 is, d = 33 takes two passes; an
    # offset of one element makes x2 a view whose base is not 16-byte aligned.
    x1, x2, w, scale, cat = _inputs(n1, n2, d, n_cat, seed=n1 * n2 + d)
    args = [torch.as_tensor(a).to(cuda_device) for a in (x1, x2, w, scale, cat)]
    if offset:
        storage = torch.zeros(offset + n2 * d, device=cuda_device)
        storage[offset:] = args[1].reshape(-1)
        args[1] = storage[offset:].view(n2, d)
        assert args[1].storage_offset() == offset and args[1].is_contiguous()
    before = matern.LAUNCHES
    out = matern.matern52_gram(*args)
    torch.cuda.synchronize()
    assert matern.LAUNCHES == before + 1
    np.testing.assert_allclose(np64(out), np64(matern.matern52_gram_plain(*args)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np64(out), _oracle(x1, x2, w, scale, cat), rtol=0, atol=1e-6)
