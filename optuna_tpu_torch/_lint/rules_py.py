"""General hygiene rules: PY001 broad exception handlers.

A ``try/except Exception`` swallows everything from a typo'd attribute to a
KeyboardInterrupt-adjacent shutdown signal. Genuine boundary handlers exist
(heartbeat threads must not die, callback isolation, optional-import
probes) — those carry a pragma whose reason names the boundary. Everything
else names the exceptions it actually expects.
"""

from __future__ import annotations

import ast
from typing import Iterator

from optuna_tpu_torch._lint.engine import Finding, ModuleContext, Rule

_BROAD = {"Exception", "BaseException"}


def _broad_name(node: ast.AST | None) -> str | None:
    if node is None:
        return "bare except"
    if isinstance(node, ast.Name) and node.id in _BROAD:
        return f"except {node.id}"
    if isinstance(node, ast.Attribute) and node.attr in _BROAD:
        return f"except {node.attr}"
    if isinstance(node, ast.Tuple):
        for elt in node.elts:
            hit = _broad_name(elt)
            if hit is not None and hit != "bare except":
                return hit
    return None


class PY001BroadExcept(Rule):
    id = "PY001"
    title = "broad exception handler"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            hit = _broad_name(node.type)
            if hit is None:
                continue
            yield ctx.finding(
                self.id, node,
                f"{hit}: name the exceptions this boundary expects, or pragma "
                "with the reason the blanket catch is load-bearing",
            )
