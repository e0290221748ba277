"""TPE's numeric plane on the device: KDE build, candidate draw, score, argmax
(port of ``optuna_tpu/samplers/_tpe/_kernels.py``).

The reference runs this as one jit program per (bucket, dims) signature and
``vmap``s the univariate build and the per-dimension draw, score and argmax
over the numerical and the categorical dimensions. Here the dimension is a
leading axis of every tensor instead: a mixture carries a problem axis
``P`` (one problem per dimension for univariate TPE, a single joint problem
for multivariate TPE), so an ask launches the same kernels at 2 dimensions
as at 30. Plain torch ops, float32, on the sampler's device; the reference
has no Pallas kernel here.

Randomness is split from the arithmetic. A *draw* step
(:func:`univariate_draws`, :func:`joint_draws`) makes the Gumbel noise of
the component choice and of the categorical values and the uniforms of the
truncated-normal ``ppf`` from a ``torch.Generator`` seeded by the ask's
host seed. The sampling functions consume those draws with the reference's
meaning (``jax.random.categorical`` is ``argmax(logits + gumbel)``), so a
test can hand in the reference's own draws.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from optuna_tpu_torch.ops import special, truncnorm
from optuna_tpu_torch.samplers._tpe.parzen_estimator import SIGMA_DOMAIN_FLOOR

EPS_BUILD = 1e-12


class Space(NamedTuple):
    """Per-search-space constants on the device (cached by the sampler)."""

    lows: torch.Tensor  # (Dn,) transformed bounds
    highs: torch.Tensor  # (Dn,)
    steps: torch.Tensor  # (Dn,) 0 for continuous dims
    prior_mu: torch.Tensor  # (Dn,) 0.5 * (low + high)
    prior_sigma: torch.Tensor  # (Dn,) high - low (also the bandwidth ceiling)
    sigma_floor: torch.Tensor  # (Dn,) SIGMA_DOMAIN_FLOOR * (high - low)
    choice_mask: torch.Tensor  # (Dc, C) bool: choice c exists in dim d
    dist_mats: torch.Tensor | None  # (Dc, C, C) distances, None when no dim has one
    has_dist: torch.Tensor | None  # (Dc,) bool


class Obs(NamedTuple):
    """One KDE set (below or above), on the device."""

    num: torch.Tensor  # (Dn, B) transformed observations, padded
    cat: torch.Tensor  # (Dc, B) int64 choice indices, padded
    log_w: torch.Tensor  # (B,) log component weights, prior appended, padded -inf
    n: int  # real observations
    min_sigma: torch.Tensor  # (Dn,) magic-clip floor of the bandwidths
    cat_base: float  # prior_weight / max(n_components, 1), an f32 value
    cat_coef: torch.Tensor | None  # (Dc,) distance-kernel exponent scale


class Draws(NamedTuple):
    """The random inputs of one sampling problem set."""

    comp: torch.Tensor  # (P, S, B) Gumbel noise of the component choice
    uniform: torch.Tensor  # (P, S, Dn) uniforms of the truncated-normal ppf
    cat: torch.Tensor  # (P, S, Dc, C) Gumbel noise of the categorical values


class _Mixture(NamedTuple):
    log_w: torch.Tensor  # (P, B)
    mus: torch.Tensor  # (P, B, Dn)
    sigmas: torch.Tensor  # (P, B, Dn)
    lows: torch.Tensor  # (P, Dn)
    highs: torch.Tensor  # (P, Dn)
    steps: torch.Tensor  # (P, Dn)
    cat_log_probs: torch.Tensor  # (P, B, Dc, C)


# ------------------------------------------------------------------ host side


def make_space(
    lows: np.ndarray,
    highs: np.ndarray,
    steps: np.ndarray,
    n_choices: np.ndarray,
    dist_mats: np.ndarray,  # (Dc, C, C)
    has_dist: np.ndarray,
    device: torch.device,
) -> Space:
    """Upload one search space's constants. The derived bounds are computed
    in float32 on the host, as the reference's program computes them."""
    lows, highs, steps = (np.asarray(a, np.float32) for a in (lows, highs, steps))
    width = highs - lows
    choice_mask = np.arange(dist_mats.shape[-1])[None, :] < np.asarray(n_choices)[:, None]

    def up(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    any_dist = bool(np.any(has_dist))
    return Space(
        lows=up(lows),
        highs=up(highs),
        steps=up(steps),
        prior_mu=up(np.float32(0.5) * (lows + highs)),
        prior_sigma=up(width),
        sigma_floor=up(np.float32(SIGMA_DOMAIN_FLOOR) * width),
        choice_mask=up(choice_mask, torch.bool),
        dist_mats=up(dist_mats) if any_dist else None,
        has_dist=up(has_dist, torch.bool) if any_dist else None,
    )


def upload_obs(
    sets: Sequence[tuple],
    lows: np.ndarray,
    highs: np.ndarray,
    n_choices: np.ndarray,
    prior_weight: float,
    magic_clip: bool,
    with_dist: bool,
    device: torch.device,
) -> list[Obs]:
    """Pack the observation sets ``(obs_num, obs_cat, log_w, n, n_k)`` (the
    reference's per-set arguments) and their per-ask scalars into one host
    buffer, copy it to ``device`` once, and return views of it.

    The per-ask scalars are float32 arithmetic on the host in the
    reference's order: the magic-clip floor ``(high - low) / min(100, 1 +
    n_k)``, the categorical base ``prior_weight / max(n_k, 1)`` and the
    distance-kernel scale ``log(max(n_k, 1) / prior_weight) * log(C) /
    log(6)``."""
    f32 = np.float32
    width = np.asarray(highs, f32) - np.asarray(lows, f32)
    pw = f32(prior_weight)
    log_c = np.log(np.asarray(n_choices, f32))
    parts: list[np.ndarray] = []
    cat_parts: list[np.ndarray] = []
    meta = []
    for obs_num, obs_cat, log_w, n, n_k in sets:
        n_k = f32(n_k)
        if magic_clip:
            min_sigma = width / np.minimum(f32(100.0), f32(1.0) + n_k)
        else:
            min_sigma = np.full_like(width, f32(EPS_BUILD))
        n_comp = np.maximum(n_k, f32(1.0))
        coef = np.log(n_comp / pw) * log_c / np.log(f32(6.0)) if with_dist else np.zeros(0, f32)
        parts += [np.asarray(obs_num, f32).ravel(), np.asarray(log_w, f32), min_sigma.astype(f32), coef.astype(f32)]
        cat_parts.append(np.asarray(obs_cat, f32).ravel())
        meta.append((np.shape(obs_num), np.shape(obs_cat), len(log_w), int(n), float(pw / n_comp), len(coef)))
    host = torch.from_numpy(np.concatenate(parts + cat_parts))
    # To the card from pinned memory, asynchronously: the ask's only host
    # wait is the read of its result.
    buf = host.pin_memory().to(device, non_blocking=True) if torch.device(device).type == "cuda" else host
    n_float = sum(p.size for p in parts)
    cats = buf[n_float:].long()
    out, off, cat_off = [], 0, 0
    for num_shape, cat_shape, b, n, base, n_coef in meta:
        dn = num_shape[0]
        num = buf[off:off + dn * b].view(num_shape)
        off += dn * b
        log_w = buf[off:off + b]
        off += b
        min_sigma = buf[off:off + dn]
        off += dn
        coef = buf[off:off + n_coef] if with_dist else None
        off += n_coef
        dc = cat_shape[0]
        cat = cats[cat_off:cat_off + dc * b].view(cat_shape)
        cat_off += dc * b
        out.append(Obs(num, cat, log_w, n, min_sigma, base, coef))
    return out


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel from uniforms, ``-log(-log(U))`` with U in [tiny, 1)
    as ``jax.random.gumbel`` forms them."""
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def _draw(seed: int, gumbel_shapes, uniform_shapes, device) -> list[torch.Tensor]:
    """One generator, one ``rand`` for every draw of an ask, split into the
    shapes asked for (Gumbel noise first, then the uniforms)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    g_sizes = [int(np.prod(s)) for s in gumbel_shapes]
    u_sizes = [int(np.prod(s)) for s in uniform_shapes]
    flat = torch.rand(sum(g_sizes) + sum(u_sizes), generator=gen, device=device, dtype=torch.float32)
    gum = _gumbel(flat[: sum(g_sizes)])
    out = [t.view(s) for t, s in zip(torch.split(gum, g_sizes), gumbel_shapes)]
    uni = flat[sum(g_sizes):]
    out += [t.view(s) for t, s in zip(torch.split(uni, u_sizes), uniform_shapes)]
    return out


def univariate_draws(
    seed: int, n_num: int, n_cat: int, n_samples: int, n_components: int, cmax: int, device
) -> tuple[Draws, Draws]:
    """Draws of univariate TPE: one problem per numerical dim, then one per
    categorical dim, each with ``n_samples`` candidates from ``n_components``
    below components."""
    s, b = n_samples, n_components
    g_num, g_ccomp, g_cat, u_num = _draw(
        seed, [(n_num, s, b), (n_cat, s, b), (n_cat, s, 1, cmax)], [(n_num, s, 1)], device
    )
    num = Draws(g_num, u_num, g_num.new_zeros((n_num, s, 0, cmax)))
    cat = Draws(g_ccomp, g_ccomp.new_zeros((n_cat, s, 0)), g_cat)
    return num, cat


def joint_draws(
    seed: int, n_num: int, n_cat: int, n_samples: int, n_components: int, cmax: int, device
) -> Draws:
    """Draws of multivariate TPE: one joint problem."""
    comp, cat, uniform = _draw(
        seed, [(1, n_samples, n_components), (1, n_samples, n_cat, cmax)], [(1, n_samples, n_num)], device
    )
    return Draws(comp, uniform, cat)


# --------------------------------------------------------------- KDE build


def build_num(obs: Obs, space: Space, consider_endpoints: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(mus, sigmas), each (Dn, B), for every numerical dim at once: sorted
    neighbour gaps with the [low, obs..., high] endpoints, the magic clip and
    the zero-variance floor; slot ``n`` is the prior, padded slots carry the
    prior's mu and sigma (masked by -inf weights). Reference
    ``_build_num_dim`` (``_kernels.py:114``)."""
    x_obs, n = obs.num, obs.n
    dn, b = x_obs.shape
    idx = torch.arange(b, device=x_obs.device)
    obs_mask = idx < n
    big = torch.finfo(x_obs.dtype).max
    x = torch.where(obs_mask, x_obs, big)
    # Stable, as jnp.argsort: which of equal observations gets which gap
    # follows their order in the history.
    order = torch.argsort(x, dim=1, stable=True)
    sorted_x = torch.gather(x, 1, order)
    prev_x = torch.cat([space.lows[:, None], sorted_x[:, :-1]], dim=1)
    left_gap = sorted_x - prev_x
    next_x = torch.cat([sorted_x[:, 1:], torch.full((dn, 1), big, device=x.device)], dim=1)
    right_gap = torch.where(idx == n - 1, space.highs[:, None] - sorted_x, next_x - sorted_x)
    sig_sorted = torch.maximum(left_gap, right_gap)
    if not consider_endpoints and n >= 2:
        # The first and last observation use their single inner gap.
        sig_sorted = torch.where(idx == 0, right_gap, sig_sorted)
        sig_sorted = torch.where(idx == n - 1, left_gap, sig_sorted)
    sigmas = torch.empty_like(sig_sorted).scatter_(1, order, sig_sorted)
    sigmas = torch.minimum(torch.maximum(sigmas, obs.min_sigma[:, None]), space.prior_sigma[:, None])
    sigmas = torch.maximum(sigmas, space.sigma_floor[:, None])
    mus = torch.where(obs_mask, x_obs, space.prior_mu[:, None])
    sigmas = torch.where(obs_mask, sigmas, space.prior_sigma[:, None])
    return mus, sigmas


def build_cat(obs: Obs, space: Space) -> torch.Tensor:
    """(Dc, B, C) log-probability tables of every categorical dim at once:
    smoothed one-hot rows, or, for dims with a distance function, rows
    replaced by ``exp(-(d(obs, .) / row_max)^2 * coef)``. Reference
    ``_build_cat_dim`` (``_kernels.py:156``)."""
    cat, n = obs.cat, obs.n
    dc, b = cat.shape
    cmax = space.choice_mask.shape[1]
    obs_mask = torch.arange(b, device=cat.device) < n
    choice_mask = space.choice_mask[:, None, :]  # (Dc, 1, C)
    choice = torch.arange(cmax, device=cat.device)
    onehot = (choice == cat[:, :, None]) & obs_mask[None, :, None] & choice_mask
    prior_row = torch.where(choice_mask, obs.cat_base, 0.0)
    probs = prior_row + onehot.to(torch.float32)
    if space.dist_mats is not None:
        d_rows = torch.gather(space.dist_mats, 1, cat[:, :, None].expand(dc, b, cmax))
        row_max = torch.amax(torch.where(choice_mask, d_rows, -torch.inf), dim=2, keepdim=True)
        row_max = torch.clamp(row_max, min=EPS_BUILD)
        r = d_rows / row_max
        kern = torch.exp(-(r * r) * obs.cat_coef[:, None, None]) * choice_mask
        probs_dist = torch.where(obs_mask[None, :, None], kern, prior_row)
        probs = torch.where(space.has_dist[:, None, None], probs_dist, probs)
    row_sums = probs.sum(dim=2, keepdim=True)
    probs = probs / torch.where(row_sums == 0, 1.0, row_sums)
    return torch.where(choice_mask & (probs > 0), torch.log(torch.clamp(probs, min=EPS_BUILD)), -torch.inf)


# ------------------------------------------------------- draw, score, argmax


def _sample_from(mix: _Mixture, draws: Draws) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, S, Dn) numerical and (P, S, Dc) categorical samples of each
    problem's mixture. Reference ``_sample_from`` (``_kernels.py:66``)."""
    idx = torch.argmax(draws.comp + mix.log_w[:, None, :], dim=2)  # (P, S)
    p, s = idx.shape
    dn = mix.mus.shape[2]
    dc, cmax = mix.cat_log_probs.shape[2:]
    if dn > 0:
        gi = idx[:, :, None].expand(p, s, dn)
        mu = torch.gather(mix.mus, 1, gi)
        sigma = torch.gather(mix.sigmas, 1, gi)
        lows, highs, steps = mix.lows[:, None, :], mix.highs[:, None, :], mix.steps[:, None, :]
        a = (lows - mu) / sigma
        b = (highs - mu) / sigma
        x = truncnorm.ppf(draws.uniform, a, b) * sigma + mu
        # Snap discrete dims onto their grid (low+half .. high-half centres).
        half = 0.5 * steps
        grid = lows + half + torch.round((x - lows - half) / torch.where(steps > 0, steps, 1.0)) * steps
        x_num = torch.where(steps > 0, grid, x)
        x_num = torch.minimum(torch.maximum(x_num, lows), highs)
    else:
        x_num = mix.mus.new_zeros((p, s, 0))
    if dc > 0:
        logits = torch.gather(mix.cat_log_probs, 1, idx[:, :, None, None].expand(p, s, dc, cmax))
        x_cat = torch.argmax(draws.cat + logits, dim=3)
    else:
        x_cat = idx.new_zeros((p, s, 0))
    return x_num, x_cat


def _log_pdf(x_num: torch.Tensor, x_cat: torch.Tensor, mix: _Mixture) -> torch.Tensor:
    """(P, S) log density of each sample under its problem's mixture.
    Reference ``_component_log_pdf`` (``_kernels.py:22``)."""
    parts = mix.log_w[:, None, :]  # (P, 1, B)
    p, s = x_num.shape[:2]
    b, dn = mix.mus.shape[1:]
    dc, cmax = mix.cat_log_probs.shape[2:]
    if dn > 0:
        x = x_num[:, :, None, :]  # (P, S, 1, Dn)
        mu, sigma = mix.mus[:, None], mix.sigmas[:, None]  # (P, 1, B, Dn)
        lows, highs, steps = (t[:, None, None, :] for t in (mix.lows, mix.highs, mix.steps))
        a = (lows - mu) / sigma
        b_ = (highs - mu) / sigma
        z = (x - mu) / sigma
        cont = truncnorm.logpdf(z, a, b_) - torch.log(sigma)
        # Discrete dims: the mass of the step cell [x-h/2, x+h/2].
        half = 0.5 * steps
        zl = torch.maximum(a, (x - half - mu) / sigma)
        zu = torch.minimum(b_, (x + half - mu) / sigma)
        disc = truncnorm.log_mass(zl, zu) - truncnorm.log_mass(a, b_)
        per_dim = torch.where(steps > 0, disc, cont)
        parts = parts + per_dim.sum(dim=3)
    if dc > 0:
        table = mix.cat_log_probs[:, None].expand(p, s, b, dc, cmax)
        pick = x_cat[:, :, None, :, None].expand(p, s, b, dc, 1)
        parts = parts + torch.gather(table, 4, pick)[..., 0].sum(dim=3)
    return special.logsumexp(parts, dim=2)


def _score(below: _Mixture, above: _Mixture, draws: Draws):
    """Samples from ``below`` and their ``log l - log g`` score, (P, S)."""
    x_num, x_cat = _sample_from(below, draws)
    score = _log_pdf(x_num, x_cat, below) - _log_pdf(x_num, x_cat, above)
    return x_num, x_cat, score


def _pick(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """``x[p, best[p], :]`` for (P, S, D) ``x`` and (P,) ``best``: (P, D)."""
    return torch.gather(x, 1, best[:, None, None].expand(x.shape[0], 1, x.shape[2]))[:, 0]


def _num_mixture(obs: Obs, mus, sigmas, space: Space, joint: bool) -> _Mixture:
    dn, b = mus.shape
    if joint:
        return _Mixture(
            obs.log_w[None], mus.T[None], sigmas.T[None], space.lows[None], space.highs[None],
            space.steps[None], mus.new_zeros((1, b, 0, 1)),
        )
    return _Mixture(
        obs.log_w.expand(dn, b), mus[:, :, None], sigmas[:, :, None], space.lows[:, None],
        space.highs[:, None], space.steps[:, None], mus.new_zeros((dn, b, 0, 1)),
    )


def sample_univariate_from_obs(
    below: Obs, above: Obs, space: Space, draws: tuple[Draws, Draws], consider_endpoints: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Univariate TPE for every dimension, from raw observations: the KDE
    build, then per dimension the draw, score and argmax, all dims in one
    batch. Returns (Dn,) transformed numerical values and (Dc,) choice
    indices. Reference ``sample_univariate_from_obs`` (``_kernels.py:203``)."""
    dn, dc = below.num.shape[0], below.cat.shape[0]
    num_draws, cat_draws = draws
    num_out = below.num.new_zeros(0)
    cat_out = below.cat.new_zeros(0)
    if dn > 0:
        bm, bs = build_num(below, space, consider_endpoints)
        am, as_ = build_num(above, space, consider_endpoints)
        bmix = _num_mixture(below, bm, bs, space, joint=False)
        amix = _num_mixture(above, am, as_, space, joint=False)
        x_num, _, score = _score(bmix, amix, num_draws)
        num_out = _pick(x_num, torch.argmax(score, dim=1))[:, 0]
    if dc > 0:
        bp, ap = build_cat(below, space), build_cat(above, space)
        empty = bp.new_zeros((dc, 0))

        def mixture(obs: Obs, probs: torch.Tensor) -> _Mixture:
            b = probs.shape[1]
            return _Mixture(
                obs.log_w.expand(dc, b), probs.new_zeros((dc, b, 0)), probs.new_ones((dc, b, 0)),
                empty, empty, empty, probs[:, :, None, :],
            )

        _, x_cat, score = _score(mixture(below, bp), mixture(above, ap), cat_draws)
        cat_out = _pick(x_cat, torch.argmax(score, dim=1))[:, 0]
    return num_out, cat_out


def _joint_mixture(obs: Obs, space: Space, consider_endpoints: bool) -> _Mixture:
    """The joint (multivariate) mixture: the same per-dim bandwidths as the
    univariate build (the reference has no separate multivariate bandwidth
    branch), in the (B, D) layout. Reference ``_make_joint_pack`` (``:329``)."""
    dn, dc = obs.num.shape[0], obs.cat.shape[0]
    b = obs.log_w.shape[0]
    if dn > 0:
        mus, sigmas = build_num(obs, space, consider_endpoints)
        mix = _num_mixture(obs, mus, sigmas, space, joint=True)
    else:
        zeros = obs.log_w.new_zeros((1, 0))
        mix = _Mixture(
            obs.log_w[None], obs.log_w.new_zeros((1, b, 0)), obs.log_w.new_ones((1, b, 0)),
            zeros, zeros, zeros, obs.log_w.new_zeros((1, b, 0, 1)),
        )
    if dc > 0:
        mix = mix._replace(cat_log_probs=build_cat(obs, space).permute(1, 0, 2)[None])
    return mix


def sample_and_score_from_obs(
    below: Obs, above: Obs, space: Space, draws: Draws, consider_endpoints: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multivariate TPE: joint KDE build, draw, score, argmax. Returns (Dn,)
    and (Dc,). Reference ``sample_and_score_from_obs`` (``_kernels.py:374``)."""
    x_num, x_cat, score = _score(
        _joint_mixture(below, space, consider_endpoints), _joint_mixture(above, space, consider_endpoints), draws
    )
    best = torch.argmax(score, dim=1)
    return _pick(x_num, best)[0], _pick(x_cat, best)[0]


def sample_and_score_topk_from_obs(
    below: Obs, above: Obs, space: Space, draws: Draws, k: int, consider_endpoints: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best joint candidates, (k, Dn) and (k, Dc). A stable
    descending sort puts equal scores in index order, as ``lax.top_k``
    does. Reference ``sample_and_score_topk_from_obs`` (``_kernels.py:406``)."""
    x_num, x_cat, score = _score(
        _joint_mixture(below, space, consider_endpoints), _joint_mixture(above, space, consider_endpoints), draws
    )
    idx = torch.sort(score[0], descending=True, stable=True).indices[:k]
    return x_num[0, idx], x_cat[0, idx]
