# graphlint fixture: factorizations routed through the ladder helper, and
# the helper's one blessed bare call under a pragma (no SMP002).
import torch


def ladder_cholesky(K):
    L, info = torch.linalg.cholesky_ex(K)  # graphlint: ignore[SMP002] -- fixture: the ladder's own blessed call
    return L, info


def fit(K, b):
    L, _ = ladder_cholesky(K)
    return torch.cholesky_solve(b, L), torch.cholesky_inverse(L)
