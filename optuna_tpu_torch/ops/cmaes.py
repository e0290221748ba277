"""CMA-ES core in torch: ask/tell on the device (port of
``optuna_tpu/ops/cmaes.py``).

Standard (mu/mu_w, lambda)-CMA-ES with rank-one + rank-mu updates and
step-size control (CSA), the separable variant (diagonal covariance), and
LRA-style learning-rate adaptation. Bounds are [0, 1]^d (the sampler
normalizes), handled by clipping.

Where the port differs from the reference, on purpose:

* **The draws are an argument.** :func:`cma_ask` takes its standard normals
  ``z`` (n, d) as a tensor; :func:`ask_draws` makes them from a
  ``torch.Generator`` seeded by the reference's fold-in pair
  ``(seed, fold)``. ``jax.random``'s stream cannot be reproduced, so the
  parity tests hand in the reference's own draws instead.
* **Canonical eigenvector signs.** ``torch.linalg.eigh`` gives each
  eigenvector up to its sign, and cuSOLVER, the CPU's LAPACK and jaxlib's
  need not agree. :func:`_eig_decomp` flips every column so that its
  largest-magnitude entry is positive. Flipping a column of B flips the
  matching draw, so the distribution of :func:`cma_ask`'s samples does not
  change; :func:`cma_tell` uses B only through ``B diag(1/D) B^T``.
* **One host read a generation.** The state's tensors stay on the device;
  :func:`to_host` copies all of them (and the queue) in one packed read.
  ``sep`` is a Python bool, not a tensor: the branch it picks is taken on
  the host, where a device flag would cost a read every call.
* **No host-CPU routing.** The reference sends these updates to the host
  CPU backend when the default backend is remote
  (``optuna_tpu/_device_policy.py``); the port runs them where the state
  lives, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import io
import math
from typing import NamedTuple

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device


class CmaState(NamedTuple):
    mean: torch.Tensor  # (d,)
    sigma: torch.Tensor  # ()
    C: torch.Tensor  # (d, d) covariance (diagonal held in the same matrix for sep)
    p_sigma: torch.Tensor  # (d,)
    p_c: torch.Tensor  # (d,)
    generation: torch.Tensor  # () int32
    # Static-ish scalars kept in-state so the state is self-contained:
    weights: torch.Tensor  # (popsize,) recombination weights (zeros beyond mu)
    mu_eff: torch.Tensor
    c_sigma: torch.Tensor
    d_sigma: torch.Tensor
    c_c: torch.Tensor
    c_1: torch.Tensor
    c_mu: torch.Tensor
    chi_n: torch.Tensor
    sep: bool  # separable (diagonal) update; a host bool, see the module docstring
    # Learning-rate adaptation: EMA signal/noise trackers for the mean and
    # covariance updates plus the adapted rates themselves. Inert (eta == 1,
    # trackers unread) unless cma_tell(..., lr_adapt=True).
    eta_m: torch.Tensor  # ()
    eta_c: torch.Tensor  # ()
    e_m: torch.Tensor  # (d,) EMA of normalized mean updates
    v_m: torch.Tensor  # () EMA of their squared norm
    e_c: torch.Tensor  # (d, d) EMA of covariance updates
    v_c: torch.Tensor  # () EMA of their squared Frobenius norm


#: The fields held as tensors (every field but ``sep``), in state order.
_TENSOR_FIELDS = tuple(f for f in CmaState._fields if f != "sep")


def default_popsize(dim: int) -> int:
    return 4 + int(3 * math.log(dim)) if dim > 1 else 6


def _to_device(flat: np.ndarray, device: torch.device) -> torch.Tensor:
    """One float32 host buffer on ``device``; to the card from pinned memory,
    asynchronously, so the copy is no synchronizing call."""
    host = torch.as_tensor(np.ascontiguousarray(flat, dtype=np.float32))
    return host.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else host


def _upload(host: CmaState, device: torch.device) -> CmaState:
    """A host state (numpy fields) on ``device``, in one packed copy."""
    arrays = [np.asarray(getattr(host, f)) for f in _TENSOR_FIELDS]
    flat = _to_device(np.concatenate([a.reshape(-1) for a in arrays]), device)
    out, at = {}, 0
    for f, a in zip(_TENSOR_FIELDS, arrays):
        t = flat[at : at + a.size].reshape(a.shape)
        out[f] = t.to(torch.int32) if f == "generation" else t
        at += a.size
    return CmaState(sep=bool(host.sep), **out)


def to_host(state: CmaState, *tensors: torch.Tensor) -> tuple[CmaState, list[np.ndarray]]:
    """``(state, tensors)`` as numpy, in ONE device-to-host copy of a packed
    buffer: every tensor field of the state, then each of ``tensors``."""
    parts = [getattr(state, f) for f in _TENSOR_FIELDS] + list(tensors)
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).cpu().numpy()
    arrays, at = [], 0
    for p in parts:
        arrays.append(flat[at : at + p.numel()].reshape(tuple(p.shape)))
        at += p.numel()
    fields = dict(zip(_TENSOR_FIELDS, arrays))
    fields["generation"] = fields["generation"].astype(np.int32)
    return CmaState(sep=bool(state.sep), **fields), arrays[len(_TENSOR_FIELDS):]


def upload_population(X: np.ndarray, fitness: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A generation's ``(X (lam, d), fitness (lam,))`` on ``device``, in one
    packed copy."""
    flat = _to_device(np.concatenate([np.ravel(X), np.ravel(fitness)]), device)
    return flat[: X.size].reshape(X.shape), flat[X.size :]


def _host_view(state: CmaState) -> CmaState:
    if isinstance(state.mean, np.ndarray):
        return state
    return to_host(state)[0]


def cma_init(
    mean0: np.ndarray,
    sigma0: float,
    popsize: int | None = None,
    sep: bool = False,
    *,
    device=None,
) -> CmaState:
    d = len(mean0)
    lam = popsize or default_popsize(d)
    mu = lam // 2
    raw = np.log((lam + 1) / 2) - np.log(np.arange(1, lam + 1))
    w = np.clip(raw, 0, None)
    w[:mu] = raw[:mu] / raw[:mu].sum()
    w[mu:] = 0.0
    mu_eff = 1.0 / np.sum(w[:mu] ** 2)

    c_sigma = (mu_eff + 2) / (d + mu_eff + 5)
    d_sigma = 1 + 2 * max(0.0, math.sqrt((mu_eff - 1) / (d + 1)) - 1) + c_sigma
    c_c = (4 + mu_eff / d) / (d + 4 + 2 * mu_eff / d)
    c_1 = 2 / ((d + 1.3) ** 2 + mu_eff)
    c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((d + 2) ** 2 + mu_eff))
    if sep:
        # Larger learning rate is admissible for the diagonal model.
        c_1 = c_1 * (d + 1.5) / 3
        c_mu = min(1 - c_1, c_mu * (d + 1.5) / 3)
    chi_n = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))

    f32 = lambda v: np.asarray(v, dtype=np.float32)  # noqa: E731
    host = CmaState(
        mean=f32(mean0), sigma=f32(sigma0), C=np.eye(d, dtype=np.float32),
        p_sigma=np.zeros(d, np.float32), p_c=np.zeros(d, np.float32), generation=np.asarray(0, np.int32),
        weights=f32(w), mu_eff=f32(mu_eff), c_sigma=f32(c_sigma), d_sigma=f32(d_sigma), c_c=f32(c_c),
        c_1=f32(c_1), c_mu=f32(c_mu), chi_n=f32(chi_n), sep=bool(sep),
        eta_m=f32(1.0), eta_c=f32(1.0), e_m=np.zeros(d, np.float32), v_m=f32(0.0),
        e_c=np.zeros((d, d), np.float32), v_c=f32(0.0),
    )
    return _upload(host, resolve_device(device))


def _eig_decomp(state: CmaState) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, D_diag_sqrt): eigenbasis and sqrt eigenvalues, diagonal-aware.
    Each column of B has its largest-magnitude entry positive (the module
    docstring says why)."""
    C = state.C
    if state.sep:
        d = C.shape[0]
        return torch.eye(d, dtype=C.dtype, device=C.device), torch.sqrt(torch.clamp(torch.diagonal(C), min=1e-20))
    w, B = torch.linalg.eigh(C)
    pivot = torch.argmax(B.abs(), dim=0, keepdim=True)
    signs = torch.sign(torch.gather(B, 0, pivot))
    B = B * torch.where(signs == 0, 1.0, signs)
    return B, torch.sqrt(torch.clamp(w, min=1e-20))


def ask_draws(seed: int, fold: int, n: int, d: int, device) -> torch.Tensor:
    """Standard normals (n, d) for one ask, from a ``torch.Generator`` on
    ``device`` seeded by the reference's fold-in pair: the reference asks
    with ``normal(fold_in(PRNGKey(seed), fold), (n, d))``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(fold) & 0xFFFFFFFF))
    return torch.randn((n, d), generator=gen, device=device, dtype=torch.float32)


def cma_ask(state: CmaState, z: torch.Tensor) -> torch.Tensor:
    """Candidates (n, d) in [0, 1]^d (clipped) from the draws ``z`` (n, d)."""
    B, D = _eig_decomp(state)
    y = (z * D[None, :]) @ B.T  # (n, d) ~ N(0, C)
    # One rounding for mean + sigma * y, as the reference's fused multiply-add.
    x = torch.addcmul(state.mean[None, :], state.sigma, y)
    return torch.clamp(x, 0.0, 1.0)


def _project(C: torch.Tensor, sep: bool) -> torch.Tensor:
    """The separable variant keeps only the diagonal; the full one is symmetrized."""
    return torch.diag(torch.diagonal(C)) if sep else 0.5 * (C + C.T)


def cma_tell(state: CmaState, X: torch.Tensor, fitness: torch.Tensor, lr_adapt: bool = False) -> CmaState:
    """One generation update from the evaluated population (X (lam, d), minimize)."""
    d = state.mean.shape[0]
    order = torch.argsort(fitness, stable=True)
    X_sorted = X[order]
    w = state.weights

    y_k = (X_sorted - state.mean[None, :]) / state.sigma  # (lam, d)
    y_w = torch.sum(w[:, None] * y_k, dim=0)  # weighted mean step
    mean_new = state.mean + state.sigma * y_w

    B, D = _eig_decomp(state)
    # C^{-1/2} y_w
    c_inv_sqrt_yw = B @ ((B.T @ y_w) / D)
    p_sigma = (1 - state.c_sigma) * state.p_sigma + torch.sqrt(
        state.c_sigma * (2 - state.c_sigma) * state.mu_eff
    ) * c_inv_sqrt_yw

    norm_p_sigma = torch.linalg.vector_norm(p_sigma)
    sigma_new = state.sigma * torch.exp((state.c_sigma / state.d_sigma) * (norm_p_sigma / state.chi_n - 1))
    sigma_new = torch.clamp(sigma_new, 1e-10, 1e3)

    h_sigma_cond = norm_p_sigma / torch.sqrt(
        1 - (1 - state.c_sigma) ** (2 * (state.generation + 1))
    ) < (1.4 + 2 / (d + 1)) * state.chi_n
    h_sigma = h_sigma_cond.to(torch.float32)

    p_c = (1 - state.c_c) * state.p_c + h_sigma * torch.sqrt(state.c_c * (2 - state.c_c) * state.mu_eff) * y_w

    delta_h = (1 - h_sigma) * state.c_c * (2 - state.c_c)
    rank_one = torch.outer(p_c, p_c)
    rank_mu = torch.einsum("k,ki,kj->ij", w, y_k, y_k)
    C_new = (
        (1 + state.c_1 * delta_h - state.c_1 - state.c_mu * torch.sum(w)) * state.C
        + state.c_1 * rank_one
        + state.c_mu * rank_mu
    )
    C_new = _project(C_new, state.sep)

    lr_fields = {}
    if lr_adapt:
        # LRA-CMA-ES-style rate adaptation: estimate the signal-to-noise
        # ratio of the (normalized) mean and covariance updates through EMAs
        # and scale each learning rate toward SNR/alpha == 1. The raw
        # updates above stay untouched; only the applied fraction changes.
        beta_m, beta_c, gamma, alpha_snr = 0.1, 0.03, 0.1, 1.4

        def adapt(e, v, delta, norm2, beta, eta):
            e_new = (1 - beta) * e + beta * delta
            v_new = (1 - beta) * v + beta * norm2
            e2 = torch.sum(e_new * e_new)
            snr = (e2 - beta / (2 - beta) * v_new) / torch.clamp(v_new - e2, min=1e-20)
            eta_new = eta * torch.exp(torch.clamp(gamma * eta, max=beta) * (snr / alpha_snr - 1.0))
            return e_new, v_new, torch.clamp(eta_new, 1e-4, 1.0)

        dm = (mean_new - state.mean) / torch.clamp(state.sigma, min=1e-20)
        e_m, v_m, eta_m = adapt(state.e_m, state.v_m, dm, torch.sum(dm * dm), beta_m, state.eta_m)
        dC = C_new - state.C
        e_c, v_c, eta_c = adapt(state.e_c, state.v_c, dC, torch.sum(dC * dC), beta_c, state.eta_c)
        mean_new = state.mean + eta_m * (mean_new - state.mean)
        C_new = _project(state.C + eta_c * (C_new - state.C), state.sep)
        lr_fields = dict(eta_m=eta_m, eta_c=eta_c, e_m=e_m, v_m=v_m, e_c=e_c, v_c=v_c)

    return state._replace(
        mean=mean_new,
        sigma=sigma_new,
        C=C_new,
        p_sigma=p_sigma,
        p_c=p_c,
        generation=state.generation + 1,
        **lr_fields,
    )


def cma_tell_and_ask(
    state: CmaState, X: torch.Tensor, fitness: torch.Tensor, z: torch.Tensor, lr_adapt: bool = False
) -> tuple[CmaState, torch.Tensor]:
    """The generation update and the next population's sampling in one call,
    with no host read: the caller reads the queue (and the state) once, with
    :func:`to_host`."""
    new_state = cma_tell(state, X, fitness, lr_adapt=lr_adapt)
    return new_state, cma_ask(new_state, z)


# ------------------------------------------------------- margin & termination


def apply_margin(state: CmaState, steps: np.ndarray, alpha: float) -> CmaState:
    """CMA-with-margin correction for discrete dims (Hamano et al. 2022).

    ``steps`` holds each dimension's normalized grid step (0 = continuous).
    For every discrete dim the per-dim std is inflated until the probability
    of sampling *outside* the mean's current grid cell is at least ``alpha``
    (>= alpha/2 per tail). Host NumPy once a generation, on one read of the
    state; a changed C is copied back to the state's device."""
    from scipy.stats import norm

    steps = np.asarray(steps, dtype=np.float64)
    if not np.any(steps > 0):
        return state
    host = _host_view(state)
    mean = np.asarray(host.mean, dtype=np.float64)
    sigma = float(host.sigma)
    C = np.array(host.C, dtype=np.float64)
    z_tail = float(norm.ppf(1.0 - alpha / 2.0))
    changed = False
    for i in np.nonzero(steps > 0)[0]:
        s = steps[i]
        cell = np.floor(mean[i] / s)
        low_edge, high_edge = s * cell, s * (cell + 1)
        sd_i = sigma * math.sqrt(max(C[i, i], 0.0))
        needed = max(high_edge - mean[i], mean[i] - low_edge) / max(z_tail, 1e-12)
        if sd_i < needed:
            C[i, i] = (needed / max(sigma, 1e-20)) ** 2
            changed = True
    if not changed:
        return state
    return state._replace(C=_to_device(C, state.C.device).reshape(C.shape))


def should_stop(
    state: CmaState,
    fitness: np.ndarray,
    best_history: np.ndarray,
    sigma0: float,
) -> str | None:
    """Restart-triggering termination criteria, evaluated on the host once per
    generation (tolfun/tolx/tolxup/conditioncov/noeffect*/stagnation).

    Returns the name of the tripped criterion, or None."""
    host = _host_view(state)
    mean = np.asarray(host.mean, dtype=np.float64)
    sigma = float(host.sigma)
    C = np.array(host.C, dtype=np.float64)
    d = len(mean)
    diag = np.clip(np.diagonal(C), 0.0, None)

    f = np.asarray(fitness, dtype=np.float64)
    if len(f) and np.ptp(f) < 1e-12 and (
        len(best_history) >= 10 and np.ptp(best_history[-10:]) < 1e-12
    ):
        return "tolfun"
    tolx = 1e-12 * sigma0
    if np.all(sigma * np.sqrt(diag) < tolx) and np.all(sigma * np.abs(np.asarray(host.p_c)) < tolx):
        return "tolx"
    eigvals = diag if host.sep else np.clip(np.linalg.eigvalsh(C), 0.0, None)
    if sigma * math.sqrt(float(np.max(eigvals, initial=0.0))) > 1e4 * sigma0:
        return "tolxup"
    lo = float(np.min(eigvals, initial=0.0))
    if lo > 0 and float(np.max(eigvals)) / lo > 1e14:
        return "conditioncov"
    if np.all(mean == mean + 0.2 * sigma * np.sqrt(diag)):
        return "noeffectcoord"
    gen = int(host.generation)
    if not host.sep and d > 0:
        w, B = np.linalg.eigh(C)
        i = gen % d
        axis = 0.1 * sigma * math.sqrt(max(w[i], 0.0)) * B[:, i]
        if np.all(mean == mean + axis):
            return "noeffectaxis"
    if len(best_history) > 120 + 30 * d:
        recent = best_history[-20:]
        older = best_history[-(120 + 30 * d):][:20]
        if np.median(recent) >= np.median(older):
            return "stagnation"
    return None


# ------------------------------------------------------------- serialization


def state_to_bytes(state: CmaState, extra: dict[str, np.ndarray] | None = None) -> bytes:
    """The port's own npz of a state (on any device, or already on the host)
    and the sampler's host extras. It need not load in the reference."""
    host = _host_view(state)
    arrays = {f"f{i}": np.asarray(leaf) for i, leaf in enumerate(host)}
    for k, v in (extra or {}).items():
        arrays[f"x_{k}"] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def state_from_bytes(data: bytes, *, device=None) -> tuple[CmaState, dict[str, np.ndarray]]:
    with np.load(io.BytesIO(data)) as z:
        leaves = [z[f"f{i}"] for i in range(len(CmaState._fields))]
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    host = CmaState(*leaves)._replace(sep=bool(leaves[CmaState._fields.index("sep")]))
    return _upload(host, resolve_device(device)), extra
