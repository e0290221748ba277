"""The port's MLP (``optuna_tpu_torch/models/mlp.py``) and BASELINE config
#5's batched objective against the reference (``optuna_tpu/models/mlp.py``,
``bench.py::run_ours_mlp_vectorized``), on the CPU at a narrow width.

JAX's key stream cannot be matched, so the reference's weights are carried
across with ``mlp_params_from_numpy`` and both packages train the same
network on the same ``RandomState`` data. Tolerances (float32, measured
on these shapes at 2.4e-6 for the logits, 6e-8 for 20 SGD steps, 1.2e-7
relative for the batched losses, with margin for other BLAS builds):

- logits ``FORWARD_ATOL``; the cross-entropy and every SGD step's
  parameters and loss ``STEP_ATOL``;
- config #5's final losses over 8 trials (10 SGD steps from
  ``base * init_scale`` at rate ``lr``) against the reference's
  ``jax.vmap(value_and_grad)`` program, ``BATCH_RTOL`` relative;
- the batch (one autograd call over the summed losses) against each trial
  trained alone, ``BATCH_RTOL`` relative: the trials share no parameter;
- the sharded loop's form of the same training (one-hot labels,
  ``cross_entropy_onehot``) against ``bench.py::_sharded_mlp_objective``'s
  program and against the index loss, ``BATCH_RTOL`` relative;
- a config #5 study of 16 trials through ``optimize_vectorized`` with
  ``RandomSampler`` on both packages: params bit for bit, values
  ``BATCH_RTOL`` relative.

``train_scaled_batch`` trains these in the wide layout (``wide_params``,
``wide_sgd_step`` around the head of ``ops/kernels/mlp_head.py``); one
wide step is held to autograd's batched ``sgd_step`` at ``WIDE_ATOL``
(float32 ``STEP_ATOL``; float64 1e-12), at a row count that fills the
head kernel's chunks and tiles and at one that does not. The one-hot
loss keeps autograd's path and never reaches the head.

The tests marked ``cuda`` hold one batch of 256 at config #5's full width
(784 inputs, hidden 32, 256 examples) on the card against CPU torch in
float64, within ``CARD_F64_RTOL`` plus twice CPU float32's own error; the
head kernel against its plain version in float32 and float64 on the card,
within ``HEAD_TOL`` of each output's largest magnitude; and the head's
launches a call: one a step and one for the final loss on the index
loss, none on the one-hot loss or in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu.parallel
import optuna_tpu_torch
from optuna_tpu_torch.models import mlp
from optuna_tpu_torch.ops.kernels import mlp_head
from tests._torch_port import cuda_device, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FORWARD_ATOL = 1e-5
STEP_ATOL = 1e-5
BATCH_RTOL = 1e-5
# A batch of 256 on the card against CPU torch in float64, trial by trial:
# |card - f64| <= CARD_F64_RTOL * |f64| + 2 * |cpu32 - f64|. Ten SGD steps at a
# rate near 1 amplify float32 rounding ("NVIDIA H100 80GB HBM3, 700.00 W", random draws: card 5.0e-4
# and CPU float32 4.6e-4 from float64; a TPE-chosen trial: 2.5e-4 and 1.24e-2).
CARD_F64_RTOL = 1e-3
WIDE_ATOL = {torch.float32: STEP_ATOL, torch.float64: 1e-12}
# The head kernel and its float32 plain version against the plain version in
# float64 on the card, each output's largest error over its largest magnitude.
HEAD_TOL = 1e-5
N_IN, N_HIDDEN, N_OUT, N_EXAMPLES, N_STEPS = 64, 8, 10, 32, 10


def _problem(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, n_batch=N_EXAMPLES):
    """``bench.py::_mlp_problem``'s draws, at a chosen size."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(n_batch, n_in)).astype(np.float32)
    y = rng.randint(0, n_out, n_batch).astype(np.int32)
    init = {
        "w1": rng.normal(0, 0.1, (n_in, n_hidden)).astype(np.float32),
        "b1": np.zeros(n_hidden, np.float32),
        "w2": rng.normal(0, 0.1, (n_hidden, n_out)).astype(np.float32),
        "b2": np.zeros(n_out, np.float32),
    }
    return x, y, init


@functools.lru_cache(maxsize=1)
def _reference_params():
    import jax

    from optuna_tpu.models import mlp as ref

    return tuple(np.array(a) for a in ref.init_mlp(jax.random.PRNGKey(0), N_IN, N_HIDDEN, N_OUT))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def test_forward_and_cross_entropy_match_reference():
    import jax.numpy as jnp

    from optuna_tpu.models import mlp as ref

    x, y, _ = _problem()
    rp = _reference_params()
    pp = mlp.mlp_params_from_numpy(rp, "cpu")
    ref_logits = np.array(ref.mlp_forward(ref.MLPParams(*map(jnp.asarray, rp)), jnp.asarray(x)))
    logits = mlp.mlp_forward(pp, torch.from_numpy(x))
    _close(logits, ref_logits, FORWARD_ATOL)
    ref_ce = float(ref.cross_entropy(jnp.asarray(ref_logits), jnp.asarray(y)))
    _close(float(mlp.cross_entropy(torch.from_numpy(ref_logits), torch.from_numpy(y))), ref_ce, STEP_ATOL)


@pytest.mark.parametrize("n_steps", [1, 20])
def test_sgd_steps_match_reference(n_steps):
    import jax.numpy as jnp

    from optuna_tpu.models import mlp as ref

    x, y, _ = _problem()
    rp = _reference_params()
    lr = np.float32(0.1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if n_steps == 1:
        ref_params, ref_loss = ref.sgd_step(ref.MLPParams(*map(jnp.asarray, rp)), jx, jy, jnp.asarray(lr))
        params, loss = mlp.sgd_step(mlp.mlp_params_from_numpy(rp, "cpu"), torch.from_numpy(x), torch.from_numpy(y), 0.1)
    else:
        ref_params, ref_loss = ref.train_mlp(ref.MLPParams(*map(jnp.asarray, rp)), jx, jy, jnp.asarray(lr), n_steps)
        params, loss = mlp.train_mlp(
            mlp.mlp_params_from_numpy(rp, "cpu"), torch.from_numpy(x), torch.from_numpy(y), torch.tensor(lr), n_steps
        )
    for got, want in zip(params, ref_params):
        _close(got, want, STEP_ATOL)
    _close(float(loss), float(ref_loss), STEP_ATOL)


def test_init_mlp_draws_from_the_generator():
    g = torch.Generator().manual_seed(3)
    a = mlp.init_mlp(g, 784, 32, 10)
    b = mlp.init_mlp(torch.Generator().manual_seed(3), 784, 32, 10)
    assert [tuple(p.shape) for p in a] == [(784, 32), (32,), (32, 10), (10,)]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not a.b1.any() and not a.b2.any()
    assert abs(float(a.w1.std()) - (2.0 / 784) ** 0.5) < 0.01 * (2.0 / 784) ** 0.5 * 10


def _reference_batch_program(init, x, y, n_steps):
    """``bench.py::run_ours_mlp_vectorized``'s objective, at any size."""
    import jax
    import jax.numpy as jnp

    from optuna_tpu.models.mlp import MLPParams, cross_entropy, mlp_forward

    base = MLPParams(*(jnp.asarray(init[k]) for k in MLPParams._fields))
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def train_one(lr, scale):
        p = jax.tree.map(lambda a: a * scale, base)

        def step(p, _):
            loss, grads = jax.value_and_grad(lambda q: cross_entropy(mlp_forward(q, jx), jy))(p)
            return jax.tree.map(lambda a, g: a - lr * g, p, grads), loss

        p, _ = jax.lax.scan(step, p, None, length=n_steps)
        return cross_entropy(mlp_forward(p, jx), jy)

    return jax.jit(lambda params: jax.vmap(train_one)(params["lr"], params["init_scale"]))


def _draws(n: int):
    rng = np.random.RandomState(1)
    lr = np.exp(rng.uniform(np.log(1e-3), 0.0, n)).astype(np.float32)
    return lr, rng.uniform(0.3, 3.0, n).astype(np.float32)


def test_config5_batched_objective_matches_reference_and_each_trial_alone():
    x, y, init = _problem()
    lr, scale = _draws(8)
    ref = np.asarray(_reference_batch_program(init, x, y, N_STEPS)({"lr": lr, "init_scale": scale}))
    base = mlp.mlp_params_from_numpy(init, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    port = mlp.train_scaled_batch(base, tx, ty, torch.from_numpy(lr), torch.from_numpy(scale), N_STEPS).numpy()
    assert port.shape == (8,) and np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=BATCH_RTOL)
    alone = []
    for rate, s in zip(lr, scale):
        params, _ = mlp.train_mlp(mlp.MLPParams(*(p * float(s) for p in base)), tx, ty, torch.tensor(rate), N_STEPS)
        alone.append(float(mlp.cross_entropy(mlp.mlp_forward(params, tx), ty)))
    np.testing.assert_allclose(port, alone, rtol=BATCH_RTOL)


def _reference_sharded_program(init, x, y, n_steps):
    """``bench.py::_sharded_mlp_objective``'s ``fn``, at any size: one-hot
    labels, a max-shifted ``logsumexp`` cross-entropy, ``n_steps`` SGD steps
    in a ``lax.scan``, trials vmapped."""
    import jax
    import jax.numpy as jnp

    jx, jyl = jnp.asarray(x), jnp.asarray(y)
    onehot = jnp.eye(init["w2"].shape[1], dtype=jnp.float32)[jyl]
    model = {k: jnp.asarray(v) for k, v in init.items()}

    def cross_entropy(logits):
        logits = logits - logits.max(axis=1, keepdims=True)
        lse = jnp.log(jnp.exp(logits).sum(axis=1))
        return jnp.mean(lse - jnp.sum(logits * onehot, axis=1))

    def train_one(m, lr, scale):
        p = {k: v * scale for k, v in m.items()}

        def forward(p):
            h = jnp.maximum(jx @ p["w1"] + p["b1"], 0.0)
            return h @ p["w2"] + p["b2"]

        def step(p, _):
            loss, grads = jax.value_and_grad(lambda q: cross_entropy(forward(q)))(p)
            return {k: v - lr * grads[k] for k, v in p.items()}, loss

        p, _ = jax.lax.scan(step, p, None, length=n_steps)
        return cross_entropy(forward(p))

    return jax.jit(lambda params: jax.vmap(train_one, in_axes=(None, 0, 0))(model, params["lr"], params["init_scale"]))


def test_config5_sharded_objective_matches_reference_and_the_index_loss():
    """The sharded loop's training (``train_scaled_batch`` with
    ``cross_entropy_onehot``) against ``bench.py::_sharded_mlp_objective``'s
    program, and against the same training on the index cross-entropy."""
    x, y, init = _problem()
    lr, scale = _draws(8)
    ref = np.asarray(_reference_sharded_program(init, x, y, N_STEPS)({"lr": lr, "init_scale": scale}))
    base = mlp.mlp_params_from_numpy(init, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    onehot = torch.eye(N_OUT)[ty.long()]
    args = (torch.from_numpy(lr), torch.from_numpy(scale), N_STEPS)
    port = mlp.train_scaled_batch(base, tx, onehot, *args, mlp.cross_entropy_onehot).numpy()
    assert port.shape == (8,) and np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=BATCH_RTOL)
    np.testing.assert_allclose(port, mlp.train_scaled_batch(base, tx, ty, *args).numpy(), rtol=BATCH_RTOL)


def test_config5_study_matches_reference():
    x, y, init = _problem()
    ref_program = _reference_batch_program(init, x, y, N_STEPS)
    base = mlp.mlp_params_from_numpy(init, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def port_fn(params):
        return mlp.train_scaled_batch(base, tx, ty, params["lr"], params["init_scale"], N_STEPS)

    def run(pkg, fn, **kwargs):
        space = {
            "lr": pkg.distributions.FloatDistribution(1e-3, 1.0, log=True),
            "init_scale": pkg.distributions.FloatDistribution(0.3, 3.0),
        }
        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
        pkg.parallel.optimize_vectorized(study, pkg.parallel.VectorizedObjective(fn, space), 16, batch_size=8, **kwargs)
        return study

    ref = run(optuna_tpu, ref_program)
    port = run(optuna_tpu_torch, port_fn, device="cpu")
    assert [t.params for t in port.trials] == [t.params for t in ref.trials]
    assert all(t.state == optuna_tpu_torch.TrialState.COMPLETE for t in port.trials)
    np.testing.assert_allclose([t.value for t in port.trials], [t.value for t in ref.trials], rtol=BATCH_RTOL)


@pytest.mark.cuda
def test_config5_batch_on_the_card_matches_cpu_torch(cuda_device):
    x, y, init = _problem(784, 32, 10, 256)
    lr, scale = _draws(256)
    out = []
    for dev, dtype in ((cuda_device, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        base = mlp.MLPParams(*(p.to(dtype) for p in mlp.mlp_params_from_numpy(init, dev)))
        args = [torch.from_numpy(a).to(dev) for a in (x, y, lr, scale)]
        out.append(mlp.train_scaled_batch(base, args[0].to(dtype), *args[1:], 10).cpu().double().numpy())
    card, cpu32, cpu64 = out
    assert np.isfinite(card).all()
    assert np.all(np.abs(card - cpu64) <= CARD_F64_RTOL * np.abs(cpu64) + 2.0 * np.abs(cpu32 - cpu64))


def _batched_start(base: mlp.MLPParams, scale: torch.Tensor) -> mlp.MLPParams:
    return mlp.MLPParams(*(p.unsqueeze(0) * scale.reshape((-1,) + (1,) * p.dim()) for p in base))


@pytest.mark.parametrize("n_rows", [2 * mlp_head.CHUNK_ROWS, mlp_head.CHUNK_ROWS + 77])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_wide_step_matches_autograds_batched_step(dtype, n_rows):
    """Both layouts start from the same bits; one wide step of 8 trials (the
    head's plain version between the two products) gives autograd's new
    parameters and losses."""
    x, y, init = _problem(n_batch=n_rows)
    lr, scale = _draws(8)
    base = mlp.MLPParams(*(p.to(dtype) for p in mlp.mlp_params_from_numpy(init, "cpu")))
    tx, ty = torch.from_numpy(x).to(dtype), torch.from_numpy(y).long()
    tlr, tscale = torch.from_numpy(lr).to(dtype), torch.from_numpy(scale)
    wide = mlp.wide_params(base, tscale)
    batched = _batched_start(base, tscale.to(dtype))
    columns = lambda w1: w1.view(N_IN, 8, N_HIDDEN).permute(1, 0, 2)  # noqa: E731
    assert torch.equal(columns(wide.w1), batched.w1)
    assert all(torch.equal(a, b) for a, b in zip(wide[1:], batched[1:]))
    new, loss = mlp.sgd_step(batched, tx, ty, tlr)
    z = torch.empty((n_rows, 8 * N_HIDDEN), dtype=dtype)
    wide_loss = mlp.wide_sgd_step(wide, tx, ty, tlr, z)
    for got, want in zip((columns(wide.w1), *wide[1:]), new):
        _close(got, want, WIDE_ATOL[dtype])
    _close(wide_loss, loss, WIDE_ATOL[dtype])


def test_train_scaled_batch_takes_the_head_on_the_index_loss_only(monkeypatch):
    calls = []
    for name in ("head_step", "head_loss"):
        monkeypatch.setattr(mlp_head, name, lambda *a, _f=getattr(mlp_head, name), _n=name: calls.append(_n) or _f(*a))
    x, y, init = _problem()
    lr, scale = (torch.from_numpy(a) for a in _draws(8))
    base = mlp.mlp_params_from_numpy(init, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    mlp.train_scaled_batch(base, tx, ty, lr, scale, N_STEPS)
    assert calls == ["head_step"] * N_STEPS + ["head_loss"]
    calls.clear()
    mlp.train_scaled_batch(base, tx, torch.eye(N_OUT)[ty.long()], lr, scale, N_STEPS, mlp.cross_entropy_onehot)
    assert calls == []


def _head_operands(n: int, trials: int, device):
    """The head's operands as the wide trainer makes them: ``X @ W1`` of
    ``trials`` scaled copies of config #5's network (784 inputs, hidden 32,
    biases made nonzero), labels in [0, 10), rates log-uniform in [1e-3, 1]."""
    x, y, init = _problem(784, 32, 10, n)
    lr, scale = _draws(trials)
    base = mlp.mlp_params_from_numpy(init, device)
    base = base._replace(b1=base.b1 + 0.05, b2=base.b2 - 0.02)
    p = mlp.wide_params(base, torch.from_numpy(scale).to(device))
    z = torch.from_numpy(x).to(device) @ p.w1
    return z, p.b1, p.w2, p.b2, torch.from_numpy(y).to(device).long(), torch.from_numpy(lr).to(device)


@pytest.mark.cuda
def test_head_kernel_matches_its_plain_version_on_the_card(cuda_device):
    """At B = 256, hidden 32 and N = 2 chunks and 101 rows (the last chunk's
    last tile part-filled): the loss alone, one step's losses and gradients
    and ``lr * dH`` over ``z``."""
    n = 2 * mlp_head.CHUNK_ROWS + 101
    z, b1, w2, b2, labels, lr = _head_operands(n, 256, cuda_device)
    before = mlp_head.LAUNCHES
    out = {}
    for label, dtype, step, loss in (
        ("kernel", torch.float32, mlp_head.head_step, mlp_head.head_loss),
        ("plain", torch.float32, mlp_head.head_step_plain, mlp_head.head_loss_plain),
        ("f64", torch.float64, mlp_head.head_step_plain, mlp_head.head_loss_plain),
    ):
        zz = z.to(dtype, copy=True)
        ops = [t.to(dtype) for t in (b1, w2, b2)]
        alone = loss(zz, *ops, labels)
        grads = step(zz, *ops, labels, lr.to(dtype))
        out[label] = [alone, *grads, zz]
    assert mlp_head.LAUNCHES - before == 2
    names = ["loss alone", "loss", "w2", "b2", "b1", "lr * dH"]
    for name, kernel, plain, ref in zip(names, *out.values()):
        assert torch.isfinite(kernel).all(), name
        scale = ref.abs().max()
        for got in (kernel, plain):
            assert float((got.double() - ref).abs().max() / scale) <= HEAD_TOL, name


@pytest.mark.cuda
def test_config5_on_the_card_launches_the_head_once_a_step_and_for_the_loss(cuda_device):
    x, y, init = _problem(784, 32, 10, 256)
    lr, scale = (torch.from_numpy(a).to(cuda_device) for a in _draws(256))
    tx, ty = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)
    base = mlp.mlp_params_from_numpy(init, cuda_device)
    calls = (
        (N_STEPS + 1, lambda: mlp.train_scaled_batch(base, tx, ty, lr, scale, N_STEPS)),
        (0, lambda: mlp.train_scaled_batch(
            base, tx, torch.eye(10, device=cuda_device)[ty.long()], lr, scale, N_STEPS, mlp.cross_entropy_onehot)),
        (0, lambda: mlp.train_scaled_batch(
            mlp.MLPParams(*(p.double() for p in base)), tx.double(), ty, lr, scale, N_STEPS)),
    )
    for want, call in calls:
        before = mlp_head.LAUNCHES
        assert torch.isfinite(call()).all()
        assert mlp_head.LAUNCHES - before == want
