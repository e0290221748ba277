"""How often the speculative chain re-proposes an incumbent: the reference's
``gp_suggest_chain_fused`` and the port's on the same histories, on the CPU.

For each seed: 960 Hartmann-20D trials from ``numpy.random.default_rng(seed)``
(as ``chip_smoke.py``'s ``seeded_study`` makes them), then the port's
``GPSampler(seed=seed, speculative_chain=8, device="cpu")`` runs 8 trials:
its first chain dispatch. The second dispatch's inputs (n = 968, bucket
1024) are packed once, by the port's sampler, and both programs run on
them with the reference's draws (``fold_in(PRNGKey(seed), i)`` for round
i, as ``tests/test_torch_gp_chain.py`` hands them in).

Printed per seed and side: how many of the 8 proposals equal one of the 4
incumbents that join the candidate pool (within 1e-6 in every coordinate),
how many equal any observed row, and how many are distinct. For the first
round, on the port's fitted state: the best LogEI over the shifted pool
against the incumbents', the LogEI gradient's largest component at each
incumbent, and the first L-BFGS step from the best incumbent: how many of
the maximizer's 10 trial step sizes Armijo accepts (an ascent that starts
there stays where it is if none is), and the largest step it accepts.

Run from the repository root:

    JAX_PLATFORMS=cpu python -m tests.torch_chain_witness [--seeds 0 1 2 3]

It takes a few minutes (the reference compiles its chain once a seed's
bucket, and each chain round factors a 1024-row Gram matrix).
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import optuna_tpu_torch as ot
from optuna_tpu.gp import fused as ref_fused
from optuna_tpu_torch.distributions import FloatDistribution
from optuna_tpu_torch.gp import fused as port_fused
from optuna_tpu_torch.gp.acqf import LogEIData, logei_value
from optuna_tpu_torch.gp.gp import params_from_raw
from optuna_tpu_torch.gp.search_space import SearchSpace
from optuna_tpu_torch.models.benchmarks import hartmann20, hartmann6_np
from optuna_tpu_torch.samplers import GPSampler

D, Q, N0 = 20, 8, 960
MIN_NOISE = 1e-5
SAME = 1e-6
MAX_LS = 10  # the line-search depth of the chain's LogEI maximizer (fused.py)
PROBE_LS = 24


def _space() -> dict:
    return {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(D)}


def _after_first_dispatch(seed: int):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(N0, D))
    study = ot.create_study(sampler=GPSampler(seed=seed, speculative_chain=Q, device="cpu"))
    study.add_trials(
        ot.create_trial(params={f"x{i}": float(r[i]) for i in range(D)}, distributions=_space(), value=float(v))
        for r, v in zip(X, hartmann6_np(X))
    )
    study.optimize(hartmann20, n_trials=Q)
    return study


def _ref_draws(key, n_cand: int):
    k_cand, k_start = jax.random.split(key)
    shift = jax.random.uniform(k_cand, (D,), dtype=jnp.float32)
    gumbel = jax.random.gumbel(k_start, (n_cand,), dtype=jnp.float32)
    return np.asarray(shift), np.asarray(gumbel)


def _counts(xs: np.ndarray, inc: np.ndarray, observed: np.ndarray) -> tuple[int, int, int]:
    def hits(rows):
        return int(sum(np.any(np.max(np.abs(rows - x), axis=1) <= SAME) for x in xs))

    distinct = len({tuple(np.round(x / SAME).astype(np.int64)) for x in xs})
    return hits(inc), hits(observed), distinct


def witness(seed: int) -> dict:
    t0 = time.perf_counter()
    study = _after_first_dispatch(seed)
    sampler = study.sampler
    space_dict = _space()
    space = SearchSpace(space_dict)
    trials = study.get_trials(deepcopy=False, states=(ot.TrialState.COMPLETE,))
    X = space.normalize([t.params for t in trials]).astype(np.float32)
    sig = sampler._space_signature(space_dict)
    warm = sampler._kernel_params_cache.get(sig)
    dev, (starts, Xp, yp, maskp, inc), _, _, common, n, fit_iters = sampler._fused_args(
        study, space, X, trials, warm, sig, seed, q=Q, pad_extra=Q
    )
    key = jax.random.PRNGKey(seed)
    n_cand = inc.shape[0] + dev.sobol_base.shape[0]
    draws = [_ref_draws(jax.random.fold_in(key, i), n_cand) for i in range(Q)]
    shifts = torch.as_tensor(np.stack([d[0] for d in draws]))
    gumbels = torch.as_tensor(np.stack([d[1] for d in draws]))

    xs, vs, raw, _ = port_fused.gp_suggest_chain_fused(
        starts, Xp, yp, dev.cat_mask, maskp, n, dev.sobol_base, inc, shifts, gumbels, MIN_NOISE, *common,
        q=Q, n_local_search=6, fit_iters=fit_iters, has_sweep=dev.has_sweep,
    )
    npy = [t.numpy() for t in common]
    ref_xs, ref_vs, ref_raw, _ = ref_fused.gp_suggest_chain_fused(
        starts.numpy(), Xp.numpy(), yp.numpy(), dev.cat_mask.numpy(), maskp.numpy(), np.int32(n),
        dev.sobol_base.numpy(), inc.numpy(), key, MIN_NOISE, *npy,
        q=Q, n_local_search=6, fit_iters=fit_iters, has_sweep=dev.has_sweep,
    )
    inc_np, observed = inc.numpy(), Xp.numpy()[:n]

    # Round 0 on the port's fitted state: the pool against the incumbents.
    state, _ = port_fused._state_for(params_from_raw(raw, D, MIN_NOISE), Xp, yp, dev.cat_mask, maskp)
    data = LogEIData(state=state, cat_mask=dev.cat_mask, best=torch.max(yp[:n]),
                     stabilizing_noise=torch.tensor(1e-10))
    pool = port_fused.device_candidates(dev.sobol_base, shifts[0], dev.cat_mask, dev.n_choices, dev.steps)
    with torch.no_grad():
        pool_best = float(torch.max(logei_value(data, pool)))
    x_inc = inc.clone().requires_grad_(True)
    v_inc = logei_value(data, x_inc)
    (g_inc,) = torch.autograd.grad(v_inc.sum(), x_inc)
    # The first L-BFGS step from the best incumbent: the ascent direction is
    # the gradient, tried at step sizes 1, 1/2, ... (clipped to the box);
    # Armijo accepts a step that gains 1e-4 of the gradient's prediction.
    # The chain's maximizer tries MAX_LS of them; past those, the largest
    # accepted one.
    b = int(torch.argmax(v_inc))
    x0, g0 = inc[b], g_inc[b]
    steps = 0.5 ** torch.arange(PROBE_LS, dtype=torch.float32)
    trys = torch.clamp(x0[None] + steps[:, None] * g0[None], 0.0, 1.0)
    with torch.no_grad():
        gains = logei_value(data, trys) - v_inc[b].detach()
    armijo = gains >= 1e-4 * torch.sum((trys - x0[None]) * g0[None], dim=1)
    accepted = torch.nonzero(armijo)[:, 0].tolist()
    return {
        "seed": seed, "n": n,
        "port": _counts(xs.numpy(), inc_np, observed), "ref": _counts(np.asarray(ref_xs), inc_np, observed),
        "port_logei": np.round(vs.numpy(), 3).tolist(), "ref_logei": np.round(np.asarray(ref_vs), 3).tolist(),
        "pool_best": pool_best, "inc_logei": np.round(v_inc.detach().numpy(), 3).tolist(),
        "inc_grad_max": np.round(np.max(np.abs(g_inc.numpy()), axis=1), 4).tolist(),
        "shortest": float(torch.max(torch.abs(trys[MAX_LS - 1] - x0))),
        "accepted_within": int(armijo[:MAX_LS].sum()),
        "first_accepted": accepted[0] if accepted else None,
        "seconds": time.perf_counter() - t0,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = parser.parse_args()
    ot.logging.set_verbosity(ot.logging.WARNING)
    for seed in args.seeds:
        r = witness(seed)
        print(
            f"seed {r['seed']} n={r['n']}: (incumbents, observed rows, distinct) of {Q}: port {r['port']}, "
            f"reference {r['ref']}; LogEI per round port {r['port_logei']} reference {r['ref_logei']}; "
            f"round 0: best pool LogEI {r['pool_best']:.3f}, incumbents' LogEI {r['inc_logei']}, "
            f"their gradient's largest component {r['inc_grad_max']}; first ascent step from the best "
            f"incumbent: Armijo accepts {r['accepted_within']} of the maximizer's {MAX_LS} trial steps (the "
            f"shortest moves a coordinate by {r['shortest']:.3f}), the largest accepted step is "
            f"2^-{r['first_accepted']} ({r['seconds']:.1f} s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
