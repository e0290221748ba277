"""Concurrency-discipline rules: the CONC family.

The serve phase (suggestion service, ask coalescer, ready-queue worker,
hub fleet, heartbeat threads, autopilot) made the package genuinely
multi-threaded, and its thread-safety used to rest on per-PR review notes
("refresh runs OUTSIDE the policy lock"). These rules promote those notes
to enforced invariants:

* **CONC001** — interprocedural lock-order cycles. STO002's lexical
  ``with``-nesting graph, extended two ways: the graph is merged across
  *all* scanned modules (one package-wide digraph, so lock graphs that
  span files actually connect), and a ``self._method()`` call made under a
  held lock is followed one level deep into the same class, so an
  inversion hidden behind a helper method is still an edge.
* **CONC002** — blocking call under a lock in server/hot-path modules:
  storage ops, RPC dispatch, ``sleep``, thread ``join``, future
  ``.result()``, and waits on a condition other than the one(s) currently
  held. This is the tail-latency regression class of the suggestion
  service (a convoy behind one slow call), now a lint instead of a review
  comment.
* **CONC003** — thread-shared mutable write outside a lock: any
  ``self.<attr>`` a registered background-thread entrypoint assigns is
  thread-shared; a lock-free assignment to the same attr in any other
  method of the class (``__init__`` excepted — construction happens-before
  the thread starts) is a data race under the right interleaving.
* **CONC004** — the :class:`_RegistrySyncRule` machinery pointed at lock
  identity itself: ``locksan.py::LOCK_NAMES`` must equal the canonical
  ``registry.LOCKSAN_REGISTRY``, and every ``locksan.lock/rlock/
  condition("name")`` call site must use a registered name — an anonymous
  sanitized lock produces verdicts nobody can map back to a code site.

All findings are pragma-suppressable (reason mandatory, as everywhere):
deliberate boundaries — e.g. a storage write intentionally serialized
under a handle lock — are documented in place, not silently allowed.
"""

from __future__ import annotations

import ast
from typing import Iterator, Sequence

from optuna_tpu_torch._lint.engine import Finding, ModuleContext, Rule
from optuna_tpu_torch._lint.rules_storage import (
    STO002LockOrder,
    _RegistrySyncRule,
    _lock_label,
)


def _method_map(tree: ast.Module) -> dict[str, dict[str, ast.AST]]:
    """Top-level classes -> {method name: FunctionDef} for self-call
    following (one level, same class, lexical)."""
    out: dict[str, dict[str, ast.AST]] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            methods: dict[str, ast.AST] = {}
            for child in stmt.body:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[child.name] = child
            out[stmt.name] = methods
    return out


def _self_callee(node: ast.Call, methods: dict[str, ast.AST]) -> ast.AST | None:
    """The same-class method a ``self._method(...)`` call resolves to."""
    func = node.func
    if (
        isinstance(func, ast.Attribute)
        and isinstance(func.value, ast.Name)
        and func.value.id == "self"
    ):
        return methods.get(func.attr)
    return None


def _receiver_chain(node: ast.expr) -> list[str]:
    """The dotted identifier chain of an expression (``self._storage.x`` ->
    ``["self", "_storage", "x"]``); empty when not a plain chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    return parts


def _path_selected(path: str, patterns: Sequence[str]) -> bool:
    path = path.replace("\\", "/")
    return any(("/" + pat) in ("/" + path) for pat in patterns)


class CONC001LockOrder(STO002LockOrder):
    """Package-wide, interprocedural lock-order cycle detection.

    Reuses STO002's edge/cycle machinery but merges every scanned module
    into ONE acquisition digraph and, inside a ``with <lock>:`` body,
    follows ``self._method()`` calls one level into the same class — the
    held set flows into the callee, so an order inversion split across a
    caller and its helper is still a cycle.
    """

    id = "CONC001"
    title = "interprocedural lock-order cycle"

    def check_project(
        self, modules: Sequence[ModuleContext], config
    ) -> Iterator[Finding]:
        edges: dict[str, dict[str, tuple[str, int]]] = {}
        scanned = False
        for ctx in modules:
            if not _path_selected(ctx.path, config.conc001_paths):
                continue
            if not config.rule_enabled(self.id, ctx.path):
                continue
            scanned = True
            module = ctx.path.replace("\\", "/").rsplit("/", 1)[-1].removesuffix(".py")
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
        methods_by_class = _method_map(ctx.tree)

        def visit(
            node: ast.AST, class_name: str, held: tuple[str, ...], inlined: bool
        ) -> None:
            if isinstance(node, ast.ClassDef):
                for child in ast.iter_child_nodes(node):
                    visit(child, node.name, held, inlined)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                # Defined under a lock != executed under it (STO002's rule).
                for child in ast.iter_child_nodes(node):
                    visit(child, class_name, (), inlined)
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
                    visit(child, class_name, tuple(acquired), inlined)
                return
            if isinstance(node, ast.Call) and held and not inlined:
                callee = _self_callee(node, methods_by_class.get(class_name, {}))
                if callee is not None:
                    # Inline one level: the callee's body runs under the
                    # caller's held set. Calls inside the inlined body are
                    # NOT followed further (depth 1, no recursion).
                    for child in callee.body:  # type: ignore[attr-defined]
                        visit(child, class_name, held, True)
            for child in ast.iter_child_nodes(node):
                visit(child, class_name, held, inlined)

        visit(ctx.tree, "", (), False)


#: Bare/attribute call names that always block (under a lock: a convoy).
_SLEEP_NAMES = frozenset({"sleep"})
#: ``.join()`` is only a blocking join when the receiver is thread-shaped —
#: ``", ".join(parts)`` is string formatting, not synchronization.
_JOINABLE_HINTS = ("thread", "proc", "worker", "pool", "executor")


class CONC002BlockingUnderLock(Rule):
    """Blocking call inside a ``with <lock>:`` body of a hot-path module.

    Flags, while any lexically-held lock is in scope (including one level
    of ``self._method()`` inlining): ``sleep``, thread/worker ``.join()``,
    future ``.result()``, storage ops (receiver chain mentions storage),
    RPC dispatch (``self._call(...)``), and ``.wait()`` on anything other
    than a currently-held condition (waiting on a foreign condition keeps
    every other held lock held for the whole window).
    """

    id = "CONC002"
    title = "blocking call under a held lock on a serve hot path"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _path_selected(ctx.path, ctx.config.conc002_paths):
            return
        module = ctx.path.replace("\\", "/").rsplit("/", 1)[-1].removesuffix(".py")
        methods_by_class = _method_map(ctx.tree)
        seen: set[tuple[int, int, str]] = set()
        findings: list[Finding] = []

        def held_locks(held: tuple[tuple[str, str], ...]) -> str:
            return ", ".join(sorted({label for label, _ in held}))

        def classify(node: ast.Call, held: tuple[tuple[str, str], ...]) -> str | None:
            func = node.func
            name = (
                func.attr
                if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None
            )
            if name is None:
                return None
            if name in _SLEEP_NAMES:
                return f"blocking '{name}()' while holding [{held_locks(held)}]"
            if name == "join" and isinstance(func, ast.Attribute):
                chain = _receiver_chain(func.value)
                if any(
                    hint in part.lower() for part in chain for hint in _JOINABLE_HINTS
                ):
                    return (
                        f"thread join '{ast.unparse(func)}()' while holding "
                        f"[{held_locks(held)}]"
                    )
                return None
            if name == "result" and isinstance(func, ast.Attribute):
                return (
                    f"future wait '{ast.unparse(func)}()' while holding "
                    f"[{held_locks(held)}]"
                )
            if name == "wait" and isinstance(func, ast.Attribute):
                recv = ast.unparse(func.value)
                others = sorted({label for label, expr in held if expr != recv})
                if others:
                    return (
                        f"'{recv}.wait()' releases only its own lock; "
                        f"[{', '.join(others)}] stay held for the whole wait window"
                    )
                return None
            if isinstance(func, ast.Attribute):
                chain = _receiver_chain(func.value)
                if any("storage" in part.lower() for part in chain):
                    return (
                        f"storage op '{ast.unparse(func)}(...)' while holding "
                        f"[{held_locks(held)}] (storage latency convoys every waiter)"
                    )
                if name == "_call" and chain[:1] == ["self"] and len(chain) == 1:
                    return (
                        f"RPC dispatch 'self._call(...)' while holding "
                        f"[{held_locks(held)}] (network latency convoys every waiter)"
                    )
            return None

        def visit(
            node: ast.AST,
            class_name: str,
            held: tuple[tuple[str, str], ...],
            inlined: bool,
        ) -> None:
            if isinstance(node, ast.ClassDef):
                for child in ast.iter_child_nodes(node):
                    visit(child, node.name, held, inlined)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                for child in ast.iter_child_nodes(node):
                    visit(child, class_name, (), inlined)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = list(held)
                for item in node.items:
                    label = _lock_label(item.context_expr, class_name, module)
                    if label is not None:
                        acquired.append((label, ast.unparse(item.context_expr)))
                for child in node.body:
                    visit(child, class_name, tuple(acquired), inlined)
                return
            if isinstance(node, ast.Call) and held:
                message = classify(node, held)
                if message is not None:
                    key = (node.lineno, node.col_offset, message)
                    if key not in seen:
                        seen.add(key)
                        findings.append(ctx.finding(self.id, node, message))
                if not inlined:
                    callee = _self_callee(node, methods_by_class.get(class_name, {}))
                    if callee is not None:
                        for child in callee.body:  # type: ignore[attr-defined]
                            visit(child, class_name, held, True)
            for child in ast.iter_child_nodes(node):
                visit(child, class_name, held, inlined)

        visit(ctx.tree, "", (), False)
        yield from findings


def _iter_self_writes(
    method: ast.AST, class_name: str, module: str
) -> Iterator[tuple[str, ast.AST, bool]]:
    """``(attr, node, under_lock)`` for every ``self.<attr> = ...`` /
    augmented / annotated assignment lexically inside ``method``, with
    lexical lock-held status. Nested function defs reset the held set AND
    stop write collection (a callback's writes happen on whoever runs it)."""

    def targets_of(node: ast.AST) -> list[ast.expr]:
        if isinstance(node, ast.Assign):
            out: list[ast.expr] = []
            for t in node.targets:
                out.extend(t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])
            return out
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            return [node.target]
        return []

    def visit(node: ast.AST, held: bool) -> Iterator[tuple[str, ast.AST, bool]]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locked = held or any(
                _lock_label(item.context_expr, class_name, module) is not None
                for item in node.items
            )
            for child in node.body:
                yield from visit(child, locked)
            return
        for target in targets_of(node):
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                yield (target.attr, node, held)
        for child in ast.iter_child_nodes(node):
            yield from visit(child, held)

    for child in ast.iter_child_nodes(method):
        yield from visit(child, False)


class CONC003ThreadSharedWrite(Rule):
    """Thread-shared attribute mutated lock-free on the main path.

    Driven by the registered background-thread entrypoints
    (``registry.CONC003_THREAD_ENTRYPOINTS``): every ``self.<attr>`` an
    entrypoint assigns — directly or one ``self._method()`` level deep —
    is shared with the spawning thread; any other method of the class
    (``__init__`` excepted: construction happens-before ``Thread.start``)
    assigning the same attr outside a ``with <lock>:`` body is flagged at
    the main-path write site.
    """

    id = "CONC003"
    title = "thread-shared attribute written outside a lock"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        mine = [
            (qualname, why)
            for suffix, qualname, why in ctx.config.conc003_entrypoints
            if path.endswith(suffix)
        ]
        if not mine:
            return
        module = path.rsplit("/", 1)[-1].removesuffix(".py")
        methods_by_class = _method_map(ctx.tree)
        for qualname, why in mine:
            class_name, _, entry_name = qualname.partition(".")
            methods = methods_by_class.get(class_name, {})
            entry = methods.get(entry_name)
            if entry is None:
                yield Finding(
                    self.id, ctx.display_path, 1, 1,
                    f"registered thread entrypoint '{qualname}' ({why}) not "
                    "found in this module; fix the entrypoint registry "
                    "(optuna_tpu_torch/_lint/registry.py) or restore the method",
                )
                continue
            # Thread-side writes: the entrypoint plus one level of the
            # same-class methods it calls (the beat loop delegates to a
            # helper; its writes are still thread-side writes).
            thread_written: set[str] = set()
            followed = {entry_name}
            for attr, _, _ in _iter_self_writes(entry, class_name, module):
                thread_written.add(attr)
            for node in ast.walk(entry):
                if isinstance(node, ast.Call):
                    callee = _self_callee(node, methods)
                    callee_name = getattr(callee, "name", None)
                    if callee is not None and callee_name not in followed:
                        followed.add(callee_name)
                        for attr, _, _ in _iter_self_writes(
                            callee, class_name, module
                        ):
                            thread_written.add(attr)
            if not thread_written:
                continue
            for name, method in sorted(methods.items()):
                # ``followed`` holds the entrypoint plus the helpers it
                # delegates to: those bodies ARE the thread side, not the
                # main path. ``__init__`` happens-before ``Thread.start``.
                if name == "__init__" or name in followed:
                    continue
                for attr, node, under_lock in _iter_self_writes(
                    method, class_name, module
                ):
                    if attr in thread_written and not under_lock:
                        yield ctx.finding(
                            self.id, node,
                            f"'self.{attr}' is written by the background-thread "
                            f"entrypoint {qualname} ({why}) and mutated "
                            "lock-free here on the main path; hold one lock on "
                            "both sides or document the happens-before edge "
                            "with a pragma",
                        )


class CONC004LocksanRegistrySync(_RegistrySyncRule):
    """The STO001/.../FLT001 anti-drift machinery pointed at lock identity:
    ``locksan.py::LOCK_NAMES`` must equal the canonical
    ``registry.LOCKSAN_REGISTRY``, and every ``locksan.lock/rlock/
    condition("name")`` construction site in the scanned tree must use a
    registered name — a sanitized lock outside the vocabulary produces
    verdicts, counters, and postmortems nobody can map back to a code
    site."""

    id = "CONC004"
    title = "lock sanitizer vocabulary out of sync"
    noun = "lock names"

    _FACTORIES = frozenset({"lock", "rlock", "condition"})

    def _canonical(self, config) -> dict:
        return dict(config.conc004_registry)

    def _targets(self, config) -> Sequence[tuple[str, str, str]]:
        return config.conc004_targets

    def check_project(
        self, modules: Sequence[ModuleContext], config
    ) -> Iterator[Finding]:
        yield from super().check_project(modules, config)
        canonical = frozenset(self._canonical(config))
        target_suffixes = tuple(suffix for suffix, _, _ in self._targets(config))
        for ctx in modules:
            path = ctx.path.replace("\\", "/")
            if any(path.endswith(suffix) for suffix in target_suffixes):
                continue  # the vocabulary module itself is the sync target
            if not config.rule_enabled(self.id, ctx.path):
                continue
            for node in ast.walk(ctx.tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._FACTORIES
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "locksan"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    continue
                name = node.args[0].value
                if name not in canonical:
                    yield ctx.finding(
                        self.id, node,
                        f"locksan.{node.func.attr}({name!r}) uses a lock name "
                        "outside the canonical LOCKSAN_REGISTRY "
                        "(optuna_tpu_torch/_lint/registry.py); register it with a "
                        "what-it-guards reason or rename the lock",
                    )
