"""Registry-sync and storage-concurrency rules: STO001 replay-unsafe
registry sync, EXE001 non-finite policy sync, STO002 nested-lock
acquisition order.

STO001 is the anti-drift rule retried writes made necessary: the set of
storage writes that must not be blindly replayed exists in three hand-written
copies (RetryingStorage's pass-through set, the gRPC client's op-token
wire constant, the fault-injection chaos matrix). Each copy is compared
— statically, by AST constant evaluation, without importing the modules —
against the canonical ``registry.REPLAY_UNSAFE_REGISTRY``. EXE001 is the
same machinery (:class:`_RegistrySyncRule`) pointed at the batch
executor's non-finite quarantine policy literals and their chaos matrix.

STO002 builds the lock-acquisition graph from lexical ``with`` nesting
across the storage layer and flags cycles: two locks taken in both orders
on different code paths is a deadlock waiting for the right interleaving.
"""

from __future__ import annotations

import ast
from typing import Iterator, Mapping, Sequence

from optuna_tpu_torch._lint.engine import Finding, ModuleContext, ProjectRule


class _ConstSetError(Exception):
    pass


def _eval_const_strings(node: ast.AST, env: Mapping[str, frozenset[str]]) -> frozenset[str]:
    """Statically evaluate a string-set expression: literals of
    set/tuple/list/dict (keys), ``frozenset(...)``/``set(...)`` calls, names
    bound earlier in the module, and ``|`` unions thereof."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return frozenset((node.value,))
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out: frozenset[str] = frozenset()
        for elt in node.elts:
            out |= _eval_const_strings(elt, env)
        return out
    if isinstance(node, ast.Dict):
        out = frozenset()
        for key in node.keys:
            if key is None:  # **splat — not statically resolvable
                raise _ConstSetError("dict **splat is not statically evaluable")
            out |= _eval_const_strings(key, env)
        return out
    if isinstance(node, ast.Call):
        chain_ok = isinstance(node.func, ast.Name) and node.func.id in ("frozenset", "set", "tuple", "dict")
        if chain_ok and len(node.args) <= 1 and not node.keywords:
            if not node.args:
                return frozenset()
            return _eval_const_strings(node.args[0], env)
        raise _ConstSetError("unsupported call in constant set expression")
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise _ConstSetError(f"name '{node.id}' is not a known constant set")
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _eval_const_strings(node.left, env) | _eval_const_strings(node.right, env)
    raise _ConstSetError(f"unsupported node {type(node).__name__} in constant set expression")


def _module_const_sets(tree: ast.Module) -> dict[str, tuple[frozenset[str], int]]:
    """All module-level names statically evaluable to string sets, with the
    line of their (last) assignment."""
    env: dict[str, frozenset[str]] = {}
    lines: dict[str, int] = {}
    for stmt in tree.body:
        targets: list[ast.expr] = []
        value: ast.AST | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        for target in targets:
            if not isinstance(target, ast.Name):
                continue
            try:
                env[target.id] = _eval_const_strings(value, env)
                lines[target.id] = stmt.lineno
            except _ConstSetError:
                continue
    return {name: (env[name], lines[name]) for name in env}


class _RegistrySyncRule(ProjectRule):
    """Shared engine for canonical-registry anti-drift rules.

    Subclasses name a canonical ``{entry: reason}`` map and a target list of
    ``(path suffix, symbol, why)`` hand-written copies; each copy must
    statically evaluate (AST constant evaluation, no imports) to exactly the
    registry's key set.
    """

    #: What the registry's entries are, for messages ("replay-unsafe methods").
    noun = "entries"

    def _canonical(self, config) -> dict:
        raise NotImplementedError

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        raise NotImplementedError

    def check_project(
        self, modules: Sequence[ModuleContext], config
    ) -> Iterator[Finding]:
        canonical_map = self._canonical(config)
        canonical = frozenset(canonical_map)
        for suffix, symbol, why in self._targets(config):
            ctx = next(
                (m for m in modules if m.path.replace("\\", "/").endswith(suffix)), None
            )
            if ctx is None:
                continue  # that file is outside this scan — nothing to verify
            if not config.rule_enabled(self.id, ctx.path):
                continue
            const_sets = _module_const_sets(ctx.tree)
            if symbol not in const_sets:
                yield Finding(
                    self.id, ctx.display_path, 1, 1,
                    f"expected module-level '{symbol}' ({why}) statically evaluable "
                    f"to the canonical set of {self.noun}; not found",
                )
                continue
            found, line = const_sets[symbol]
            missing = sorted(canonical - found)
            extra = sorted(found - canonical)
            if missing:
                reasons = "; ".join(f"{m}: {canonical_map[m]}" for m in missing)
                yield Finding(
                    self.id, ctx.display_path, line, 1,
                    f"'{symbol}' ({why}) is missing {self.noun} "
                    f"[{', '.join(missing)}] — {reasons}",
                )
            if extra:
                yield Finding(
                    self.id, ctx.display_path, line, 1,
                    f"'{symbol}' ({why}) lists [{', '.join(extra)}] which the "
                    "canonical registry (optuna_tpu_torch/_lint/registry.py) does not; "
                    "either update the registry everywhere or drop the entry",
                )


class STO001ReplayRegistrySync(_RegistrySyncRule):
    id = "STO001"
    title = "replay-unsafe write registries out of sync"
    noun = "replay-unsafe methods"

    def _canonical(self, config) -> dict:
        return dict(config.sto001_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.sto001_targets


class EXE001NonFinitePolicySync(_RegistrySyncRule):
    id = "EXE001"
    title = "non-finite quarantine policy sets out of sync"
    noun = "non-finite policies"

    def _canonical(self, config) -> dict:
        return dict(config.exe001_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.exe001_targets


class SRV001ShedPolicySync(_RegistrySyncRule):
    """The STO001/EXE001/SMP001 anti-drift machinery pointed at the
    suggestion service's load-shedding ladder: the service's
    ``SHED_POLICIES`` literal and the chaos matrix
    ``fault_injection.py::SHED_CHAOS_POLICIES`` must both equal the
    canonical ``registry.SHED_POLICY_REGISTRY`` — a shed rung added without
    an overload scenario that forces it is a lint failure, because an
    untested rung drops asks under exactly the load that makes the drop
    hardest to debug."""

    id = "SRV001"
    title = "suggestion-service shed policy sets out of sync"
    noun = "shed policies"

    def _canonical(self, config) -> dict:
        return dict(config.srv001_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.srv001_targets


class ACT001ActionRegistrySync(_RegistrySyncRule):
    """The STO001/.../SRV001 anti-drift machinery pointed at the autopilot's
    guarded-action vocabulary: ``autopilot.py::ACTIONS`` and the chaos
    matrix ``fault_injection.py::AUTOPILOT_CHAOS_MATRIX`` must both equal
    the canonical ``registry.AUTOPILOT_ACTION_REGISTRY`` — a remediation
    added without a chaos scenario proving it fires, executes, and rolls
    back is a lint failure, not a review comment: an unproven action fires
    for the first time in production, unattended, on a study nobody is
    watching."""

    id = "ACT001"
    title = "autopilot action vocabularies out of sync"
    noun = "autopilot actions"

    def _canonical(self, config) -> dict:
        return dict(config.act001_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.act001_targets


class FLT001FleetEventSync(_RegistrySyncRule):
    """The STO001/.../ACT001 anti-drift machinery pointed at the hub fleet's
    routing-event vocabulary: ``storages/_grpc/fleet.py::FLEET_EVENTS`` and
    the chaos matrix ``fault_injection.py::HUB_CHAOS_MATRIX`` must both
    equal the canonical ``registry.FLEET_EVENT_REGISTRY`` — a failover
    event added without a hub-kill scenario that forces it is a lint
    failure: an unexercised failover path loses its first real in-flight
    ask in production, during exactly the hub death it was built for."""

    id = "FLT001"
    title = "hub-fleet event vocabularies out of sync"
    noun = "fleet events"

    def _canonical(self, config) -> dict:
        return dict(config.flt001_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.flt001_targets


class FLT002LeaseEventSync(_RegistrySyncRule):
    """The STO001/.../FLT001 anti-drift machinery pointed at the lease
    layer's ownership-transition vocabulary:
    ``storages/_grpc/fleet.py::LEASE_EVENTS`` and the chaos matrix
    ``fault_injection.py::LEASE_CHAOS_MATRIX`` must both equal the
    canonical ``registry.LEASE_EVENT_REGISTRY`` — a lease/fence transition
    added without a gray-failure scenario that forces it is a lint failure:
    an unexercised fence admits its first double-applied zombie write in
    production, during exactly the partition it was built for."""

    id = "FLT002"
    title = "lease/fence event vocabularies out of sync"
    noun = "lease events"

    def _canonical(self, config) -> dict:
        return dict(config.flt002_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.flt002_targets


class CKPT001CheckpointEventSync(_RegistrySyncRule):
    """The STO001/.../FLT001 anti-drift machinery pointed at the durable
    checkpoint layer's event vocabulary: ``checkpoint.CHECKPOINT_EVENTS``
    and the chaos matrix ``fault_injection.py::CHECKPOINT_CHAOS_MATRIX``
    must both equal the canonical ``registry.CHECKPOINT_EVENT_REGISTRY`` —
    a checkpoint lifecycle event added without a preemption scenario that
    forces it is a lint failure: an unexercised restore path loses its
    first real study to the spot fleet's *default* failure mode."""

    id = "CKPT001"
    title = "checkpoint event vocabularies out of sync"
    noun = "checkpoint events"

    def _canonical(self, config) -> dict:
        return dict(config.ckpt001_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.ckpt001_targets


# --------------------------------------------------------------------- STO002


def _lock_label(node: ast.AST, class_name: str, module: str) -> str | None:
    """Identify a ``with`` context expression as a lock; None otherwise.

    Recognized spellings: anything containing "lock"/"mutex"/"cond"
    (``threading.Condition`` IS a lock — its ``with`` acquires one), plus
    the classic ``cv`` condition-variable abbreviation as a whole
    underscore-separated token (``_cv``, ``cv_ready``; NOT ``recv``, which
    merely contains the letters).
    """
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return None
    lowered = name.lower()
    is_lock = (
        "lock" in lowered
        or "mutex" in lowered
        or "cond" in lowered
        or "cv" in lowered.strip("_").split("_")
    )
    if not is_lock:
        return None
    owner = class_name if class_name else module
    return f"{owner}.{name}"


class STO002LockOrder(ProjectRule):
    id = "STO002"
    title = "inconsistent nested lock acquisition order"

    def check_project(
        self, modules: Sequence[ModuleContext], config
    ) -> Iterator[Finding]:
        edges: dict[str, dict[str, tuple[str, int]]] = {}
        scanned = False
        for ctx in modules:
            path = ctx.path.replace("\\", "/")
            if not any(("/" + pat) in ("/" + path) for pat in config.sto002_paths):
                continue
            if not config.rule_enabled(self.id, ctx.path):
                continue
            scanned = True
            module = path.rsplit("/", 1)[-1].removesuffix(".py")
            self._collect(ctx, module, edges)
        if not scanned:
            return
        yield from self._report_cycles(edges)

    def _collect(
        self,
        ctx: ModuleContext,
        module: str,
        edges: dict[str, dict[str, tuple[str, int]]],
    ) -> None:
        def visit(node: ast.AST, class_name: str, held: tuple[str, ...]) -> None:
            if isinstance(node, ast.ClassDef):
                for child in ast.iter_child_nodes(node):
                    visit(child, node.name, held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                # A function *defined* under a lock does not execute under
                # it — a callback registered inside `with lock:` runs later,
                # lock-free. Its body starts with an empty held set.
                for child in ast.iter_child_nodes(node):
                    visit(child, class_name, ())
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = list(held)
                for item in node.items:
                    label = _lock_label(item.context_expr, class_name, module)
                    if label is None:
                        continue
                    for holder in acquired:
                        if holder != label:  # reentrant re-acquire is RLock's job
                            edges.setdefault(holder, {}).setdefault(
                                label, (ctx.display_path, node.lineno)
                            )
                    acquired.append(label)
                for child in node.body:
                    visit(child, class_name, tuple(acquired))
                return
            for child in ast.iter_child_nodes(node):
                visit(child, class_name, held)

        visit(ctx.tree, "", ())

    def _report_cycles(
        self, edges: dict[str, dict[str, tuple[str, int]]]
    ) -> Iterator[Finding]:
        # Iterative DFS cycle detection over the acquisition digraph; each
        # cycle is reported once, anchored at its lexically-first edge.
        WHITE, GRAY, BLACK = 0, 1, 2
        color: dict[str, int] = {}
        reported: set[frozenset[str]] = set()

        def dfs(start: str) -> Iterator[Finding]:
            stack: list[tuple[str, Iterator[str]]] = [(start, iter(edges.get(start, ())))]
            path: list[str] = [start]
            color[start] = GRAY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if color.get(nxt, WHITE) == GRAY:
                        cycle = path[path.index(nxt):] + [nxt]
                        key = frozenset(cycle)
                        if key not in reported:
                            reported.add(key)
                            locs = sorted(
                                edges[a][b]
                                for a, b in zip(cycle, cycle[1:])
                                if b in edges.get(a, {})
                            )
                            display, line = locs[0]
                            yield Finding(
                                self.id, display, line, 1,
                                "lock-order cycle: " + " -> ".join(cycle) + "; "
                                "two paths acquire these locks in opposite orders "
                                "(deadlock under the right interleaving)",
                            )
                    elif color.get(nxt, WHITE) == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, iter(edges.get(nxt, ()))))
                        path.append(nxt)
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
                    path.pop()

        for start in sorted(edges):
            if color.get(start, WHITE) == WHITE:
                yield from dfs(start)
