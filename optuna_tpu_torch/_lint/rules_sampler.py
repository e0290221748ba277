"""Sampler-resilience rules: SMP001 fallback-policy registry sync, SMP002
single Cholesky call site.

SMP001 is the STO001/EXE001 pattern pointed at the sampler resilience
layer: the fallback policy set exists in two hand-written copies
(``samplers/_resilience.py::FALLBACK_POLICIES`` — validated at
construction — and the chaos matrix
``testing/fault_injection.py::FALLBACK_CHAOS_POLICIES``), each statically
compared against the canonical ``registry.FALLBACK_POLICY_REGISTRY``.

SMP002 enforces the jitter-ladder contract mechanically: a bare
``torch.linalg.cholesky`` raises on an ill-conditioned Gram matrix, and a
bare ``torch.linalg.cholesky_ex`` hands back a partial factor with a
nonzero ``info`` that nobody reads — so every Cholesky in sampler code
must route through ``samplers/_resilience.py::ladder_cholesky`` (whose own
blessed bare call carries the pragma). The rule flags any call whose last
attribute is ``cholesky`` or ``cholesky_ex`` under the configured sampler
paths.
"""

from __future__ import annotations

import ast
from typing import Iterator, Sequence

from optuna_tpu_torch._lint.config import _device_path_matches
from optuna_tpu_torch._lint.engine import Finding, ModuleContext, Rule
from optuna_tpu_torch._lint.rules_storage import _RegistrySyncRule


_CHOLESKY_NAMES = frozenset({"cholesky", "cholesky_ex"})


class SMP001FallbackPolicySync(_RegistrySyncRule):
    id = "SMP001"
    title = "sampler fallback policy sets out of sync"
    noun = "fallback policies"

    def _canonical(self, config) -> dict:
        return dict(config.smp001_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.smp001_targets


class SMP002LadderCholeskyOnly(Rule):
    id = "SMP002"
    title = "bare Cholesky call in sampler code"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not any(
            _device_path_matches(ctx.path, pattern)
            for pattern in ctx.config.smp002_paths
        ):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = (
                func.attr
                if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None
            )
            if name not in _CHOLESKY_NAMES:
                continue
            yield ctx.finding(
                self.id, node,
                f"bare {name} in sampler code: on an ill-conditioned Gram "
                "matrix it raises or leaves a partial factor — route "
                f"through {ctx.config.smp002_helper}::ladder_cholesky "
                "(escalating jitter, on-card finiteness verdict)",
            )
