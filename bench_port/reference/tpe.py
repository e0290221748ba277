"""Multivariate TPE's density ratio in plain PyTorch (float64), as upstream
Optuna's ``TPESampler(multivariate=True)`` defines it with its default
``gamma``, ``weights``, prior and magic clip, and with the bandwidths that
the measured package states for its joint estimator: each dimension's
sorted-neighbour gaps (the univariate rule).

For one ask over a study's finished trials (``x``, in the search space's
working coordinates: ``log`` of a log-scaled parameter; ``values``,
minimized), the ``gamma(n)`` best trials make the "below" estimator
``l(x)`` and the rest the "above" estimator ``g(x)``, each a mixture of
truncated normals, one a trial in trial order, and one prior component. A
candidate is scored by ``log l(x) - log g(x)``; a batch ask of ``k``
proposes the ``k`` best of ``max(24, 4k)`` draws from ``l(x)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIOR_WEIGHT = 1.0
N_EI_CANDIDATES = 24
EPS = 1e-12
SQRT_2PI_LOG = 0.5 * math.log(2.0 * math.pi)


def default_gamma(n: int) -> int:
    return min(int(math.ceil(0.1 * n)), 25)


def default_weights(n: int) -> np.ndarray:
    """Flat for the newest 25 trials, a linear ramp from ``1/n`` before them."""
    if n < 25:
        return np.ones(n)
    return np.concatenate([np.linspace(1.0 / n, 1.0, num=n - 25), np.ones(25)])


def _neighbour_sigmas(mus: np.ndarray, low: float, high: float) -> np.ndarray:
    """Each observation's larger gap to its sorted neighbours, the box's
    ends counted as neighbours; the first and last observations take their
    one inner gap (endpoints not considered)."""
    n = len(mus)
    if n == 0:
        return np.empty(0)
    order = np.argsort(mus, kind="stable")
    s = np.concatenate([[low], mus[order], [high]])
    sig = np.maximum(s[1:-1] - s[:-2], s[2:] - s[1:-1])
    if n >= 2:
        sig[0] = s[2] - s[1]
        sig[-1] = s[-2] - s[-3]
    out = np.empty(n)
    out[order] = sig
    return out


class Mixture:
    """A weighted mixture of axis-aligned truncated normals on the box
    ``[lows, highs]``: the trials' components, then the prior's."""

    def __init__(self, obs: np.ndarray, lows: np.ndarray, highs: np.ndarray, device="cpu") -> None:
        n, d = obs.shape
        width = highs - lows
        w = np.append(default_weights(n), PRIOR_WEIGHT)
        self.p = w / w.sum()
        sigmas = np.empty((n, d))
        for j in range(d):
            sigmas[:, j] = _neighbour_sigmas(obs[:, j], lows[j], highs[j])
        # The magic clip: between width / min(100, 1 + components) and width.
        sigmas = np.clip(sigmas, width / min(100.0, 1.0 + n + 1), width)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

        self.device = device
        self.mus = t(np.vstack([obs, 0.5 * (lows + highs)]))
        self.sigmas = t(np.vstack([sigmas, width]))
        self.lows, self.highs = t(lows), t(highs)
        self.log_w = torch.log(torch.clamp(t(self.p), min=EPS))
        self.a = (self.lows - self.mus) / self.sigmas
        self.b = (self.highs - self.mus) / self.sigmas
        self.log_mass = torch.log(torch.special.ndtr(self.b) - torch.special.ndtr(self.a))
        # Each component's constant: its weight, normalizer and bandwidths.
        self._const = self.log_w - (SQRT_2PI_LOG * d + torch.log(self.sigmas).sum(1) + self.log_mass.sum(1))

    def log_pdf(self, x: torch.Tensor, block: int = 4096) -> torch.Tensor:
        """``log`` density at each row of ``x`` (m, d)."""
        out = []
        for s in range(0, len(x), block):
            z = (x[s:s + block, None, :] - self.mus[None]) / self.sigmas[None]
            out.append(torch.logsumexp(self._const[None] - 0.5 * (z * z).sum(2), dim=1))
        return torch.cat(out)

    def sample(self, m: int, rng: np.random.Generator) -> torch.Tensor:
        """``m`` draws: a component by weight, then its truncated normal by
        the inverse of its distribution function."""
        comp = torch.as_tensor(rng.choice(len(self.p), size=m, p=self.p), device=self.device)
        u = torch.as_tensor(rng.uniform(size=(m, self.mus.shape[1])), device=self.device)
        fa, fb = torch.special.ndtr(self.a[comp]), torch.special.ndtr(self.b[comp])
        x = self.mus[comp] + self.sigmas[comp] * torch.special.ndtri(fa + u * (fb - fa))
        return torch.minimum(torch.maximum(x, self.lows), self.highs)


class Ratio:
    """``log l(x) - log g(x)`` of one ask over ``x`` (n, d) and ``values`` (n,),
    rows in trial order."""

    def __init__(self, x: np.ndarray, values: np.ndarray, lows: np.ndarray, highs: np.ndarray, device="cpu") -> None:
        n_below = min(default_gamma(len(values)), len(values))
        best = np.sort(np.argsort(values, kind="stable")[:n_below])
        rest = np.setdiff1d(np.arange(len(values)), best)
        self.device = device
        self.below = Mixture(x[best], lows, highs, device)
        self.above = Mixture(x[rest], lows, highs, device)

    def score(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        return self.below.log_pdf(x) - self.above.log_pdf(x)

    def batch_proposals(self, k: int, rounds: int, rng: np.random.Generator) -> np.ndarray:
        """``rounds`` batch asks of ``k`` made by the reference, pooled: each
        the ``k`` best of ``max(24, 4k)`` fresh draws from ``l(x)``."""
        n = max(N_EI_CANDIDATES, 4 * k)
        out = []
        for _ in range(rounds):
            x = self.below.sample(n, rng)
            out.append(x[torch.topk(self.score(x), k).indices])
        return torch.cat(out).cpu().numpy()


def ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    """The two-sample Kolmogorov-Smirnov distance: the largest gap between
    the empirical distribution functions of ``a`` and ``b``."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / len(a)
    fb = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.max(np.abs(fa - fb)))


def ask_distance(ratio: Ratio, proposals: np.ndarray, k: int, rounds: int, rng: np.random.Generator) -> float:
    """How far a batch's proposals lie from the reference's own batch asks
    over the same trials: the largest Kolmogorov-Smirnov distance, over the
    score and each parameter, between ``proposals`` and ``rounds`` pooled
    reference asks of ``k``."""
    ref = ratio.batch_proposals(k, rounds, rng)
    dists = [ks_distance(ratio.score(proposals).cpu().numpy(), ratio.score(ref).cpu().numpy())]
    dists += [ks_distance(proposals[:, j], ref[:, j]) for j in range(proposals.shape[1])]
    return max(dists)
