# graphlint fixture: bare Cholesky calls in sampler code (SMP002). The
# config lists this file as sampler code.
import torch
from torch.linalg import cholesky


def fit(K):
    L = torch.linalg.cholesky(K)  # EXPECT: SMP002
    L_ex, info = torch.linalg.cholesky_ex(K)  # EXPECT: SMP002
    L_bare = cholesky(K)  # EXPECT: SMP002
    return L, L_ex, info, L_bare
