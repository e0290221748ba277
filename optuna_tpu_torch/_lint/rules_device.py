"""Device rules: TPU001 host read in a device program, TPU003 dtype drift,
TPU004 stray debug output, OBS001 observability taps in a device program,
OBS002-OBS005 observability vocabulary syncs.

The device rules encode the invariants the port's design stance rests on:
inside a device program nothing may force a card-to-host read (TPU001),
and f32-hardened modules never let float64 near the card or let TF32 round
an f32 product (TPU003). OBS001 extends TPU001's stance to the telemetry
spine: instrumentation is host-side by contract (``telemetry.py``'s
overhead promise), so a ``telemetry.*``/logger call inside a device
program records around the launch, not inside it.

The JAX package finds a device program from ``jit`` decorators and ``lax``
loop bodies. The port runs eagerly and has neither, so the scope is named
in ``registry.DEVICE_PROGRAMS``: each listed function, and every function
lexically nested in one. The JAX package's TPU002 (jit recompile hazard)
has no eager counterpart; ``registry.NOT_APPLICABLE_RULES`` records why.
"""

from __future__ import annotations

import ast
from typing import Iterator, Mapping

from optuna_tpu_torch._lint.engine import Finding, ModuleContext, Rule
from optuna_tpu_torch._lint.rules_storage import _RegistrySyncRule


def _attr_chain(node: ast.AST) -> list[str]:
    """``torch.linalg.cholesky`` -> ["torch", "linalg", "cholesky"]; [] when
    not a pure chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _walk_parents(tree: ast.Module) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _ancestors(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> Iterator[ast.AST]:
    cur = parents.get(node)
    while cur is not None:
        yield cur
        cur = parents.get(cur)


_Scoped = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _qualified_defs(tree: ast.Module) -> dict[str, ast.AST]:
    """Every function def by dotted qualname (``Class.method``,
    ``outer.inner``); the first def wins on a redefinition."""
    out: dict[str, ast.AST] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _Scoped):
                name = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    out.setdefault(name, child)
                visit(child, name + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _registered_programs(ctx: ModuleContext) -> Mapping[str, str]:
    path = ctx.path.replace("\\", "/")
    merged: dict[str, str] = {}
    for suffix, funcs in ctx.config.device_programs.items():
        if path.endswith(suffix):
            merged.update(funcs)
    return merged


def _program_calls(ctx: ModuleContext) -> Iterator[ast.Call]:
    """Every call in the body of a registered device program, once. Nested
    defs are reached by walking their enclosing program's body; a program's
    own decorators and default arguments run at def time, on the host."""
    defs = _qualified_defs(ctx.tree)
    seen: set[int] = set()
    for qualname in _registered_programs(ctx):
        root = defs.get(qualname)
        if root is None:
            continue
        for stmt in root.body:  # type: ignore[attr-defined]
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and id(node) not in seen:
                    seen.add(id(node))
                    yield node


def _mentions_static_shape(node: ast.AST) -> bool:
    """True when the expression reads only host-side metadata (shape/ndim/
    len/dtype/size) or is a literal (``float("inf")``), so wrapping it in
    int()/float() is not a host read."""
    if isinstance(node, ast.Constant):
        return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("shape", "ndim", "size", "dtype"):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) and sub.func.id == "len":
            return True
    return False


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and _attr_chain(node.func)[-1:] == ["device"]:
        return bool(node.args) and _is_cpu_device(node.args[0])
    return False


class TPU001HostSyncInJit(Rule):
    id = "TPU001"
    title = "host read inside a device program"

    _SYNC_BUILTINS = {"float", "int", "bool", "complex"}
    #: ``np.asarray`` of a card tensor raises instead of reading it back, so
    #: unlike the JAX package's rule it is not a host read here.
    _SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        programs = _registered_programs(ctx)
        if not programs:
            return
        defs = _qualified_defs(ctx.tree)
        for qualname, why in programs.items():
            if qualname not in defs:
                yield Finding(
                    self.id, ctx.display_path, 1, 1,
                    f"registered device program '{qualname}' ({why}) not found "
                    "in this module; fix DEVICE_PROGRAMS "
                    "(optuna_tpu_torch/_lint/registry.py) or restore the function",
                )
        for node in _program_calls(ctx):
            yield from self._check_call(ctx, node)

    def _check_call(self, ctx: ModuleContext, node: ast.Call) -> Iterator[Finding]:
        func = node.func
        if isinstance(func, ast.Name) and func.id in self._SYNC_BUILTINS:
            if node.args and not all(_mentions_static_shape(a) for a in node.args):
                yield ctx.finding(
                    self.id, node,
                    f"{func.id}() of a tensor inside a device program reads it back "
                    "to the host and stalls the stream; keep the value on the card "
                    "or hoist the read out of the program",
                )
            return
        if isinstance(func, ast.Attribute) and func.attr in self._SYNC_METHODS:
            yield ctx.finding(
                self.id, node,
                f".{func.attr}() inside a device program waits for the card; "
                "return the tensor and read it at the host boundary",
            )
            return
        if isinstance(func, ast.Attribute) and func.attr == "to":
            targets = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "device"]
            if any(_is_cpu_device(t) for t in targets):
                yield ctx.finding(
                    self.id, node,
                    ".to('cpu') inside a device program copies back to the host "
                    "and waits for the card; move it to the host boundary",
                )


class OBS001TelemetryInTrace(Rule):
    id = "OBS001"
    title = "telemetry/logging call inside a device program"

    #: Module aliases whose calls are observability taps wherever they point
    #: (``telemetry.count(...)``, ``flight.span(...)``,
    #: ``device_stats.harvest(...)``, ``logging_module.warn_once(...)``).
    _TAP_ROOTS = {
        "telemetry", "flight", "_flight", "device_stats", "_device_stats",
        "health", "_health", "logging", "logging_module",
    }
    #: Logger method names — flagged when called on something logger-shaped.
    _LOG_METHODS = {
        "debug", "info", "warning", "warn", "error", "exception", "critical", "log",
    }
    #: Receiver names that identify a logger object by convention.
    _LOGGER_NAMES = {"logger", "_logger", "log"}
    #: Bare-name calls that are observability taps regardless of receiver.
    #: ``harvest`` is the device-stats host boundary: inside a device program
    #: it reads every stat back to the host — the stats must be *returned*
    #: from the program and harvested outside it.
    _TAP_FUNCS = {"warn_once", "get_logger", "harvest"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in _program_calls(ctx):
            hit = self._classify(node)
            if hit is not None:
                yield ctx.finding(
                    self.id, node,
                    f"{hit} inside a device program: instrumentation is "
                    "host-side by contract (it must never add a host read "
                    "to the card's stream); record around the launch, "
                    "not inside it",
                )

    def _classify(self, node: ast.Call) -> str | None:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in self._TAP_FUNCS:
                return f"{func.id}()"
            return None
        chain = _attr_chain(func)
        if not chain:
            return None
        if chain[0] in self._TAP_ROOTS:
            return ".".join(chain) + "()"
        if (
            len(chain) >= 2
            and chain[-1] in self._LOG_METHODS
            and chain[-2] in self._LOGGER_NAMES
        ):
            return ".".join(chain) + "()"
        return None


class OBS002FlightEventSync(_RegistrySyncRule):
    """The STO001/EXE001/SMP001 anti-drift machinery pointed at the flight
    recorder's event-kind vocabulary: ``flight.py::EVENT_KINDS`` and the
    chaos matrix ``fault_injection.py::FLIGHT_EVENT_CHAOS_MATRIX`` must both
    equal the canonical ``registry.FLIGHT_EVENT_REGISTRY``."""

    id = "OBS002"
    title = "flight-recorder event vocabularies out of sync"
    noun = "flight event kinds"

    def _canonical(self, config) -> dict:
        return dict(config.obs002_registry)

    def _targets(self, config):
        return config.obs002_targets


class OBS003DeviceStatSync(_RegistrySyncRule):
    """The same machinery pointed at the device-stat vocabulary:
    ``device_stats.py::DEVICE_STATS`` and the chaos matrix
    ``fault_injection.py::DEVICE_STAT_CHAOS_MATRIX`` must both equal the
    canonical ``registry.DEVICE_STAT_REGISTRY``. (The companion check —
    ``harvest()`` never called inside a device program — is OBS001's.)"""

    id = "OBS003"
    title = "device-stat vocabularies out of sync"
    noun = "device stats"

    def _canonical(self, config) -> dict:
        return dict(config.obs003_registry)

    def _targets(self, config):
        return config.obs003_targets


class OBS004HealthCheckSync(_RegistrySyncRule):
    """The same machinery pointed at the study doctor's check-id
    vocabulary: ``health.py::HEALTH_CHECKS`` and the chaos matrix
    ``fault_injection.py::HEALTH_CHECK_CHAOS_MATRIX`` must both equal the
    canonical ``registry.HEALTH_CHECK_REGISTRY`` — an unproven doctor check
    certifies sick studies healthy."""

    id = "OBS004"
    title = "study-doctor check vocabularies out of sync"
    noun = "health checks"

    def _canonical(self, config) -> dict:
        return dict(config.obs004_registry)

    def _targets(self, config):
        return config.obs004_targets


class OBS005SloRegistrySync(_RegistrySyncRule):
    """The same machinery pointed at the SLO engine's objective vocabulary:
    ``slo.py::SLO_SPECS`` and the chaos matrix
    ``fault_injection.py::SLO_CHAOS_MATRIX`` must both equal the canonical
    ``registry.SLO_REGISTRY`` — an SLO nobody has shown burning certifies
    a violated promise as kept."""

    id = "OBS005"
    title = "SLO objective vocabularies out of sync"
    noun = "SLO objectives"

    def _canonical(self, config) -> dict:
        return dict(config.obs005_registry)

    def _targets(self, config):
        return config.obs005_targets


class TPU003DtypeDrift(Rule):
    id = "TPU003"
    title = "float64 or TF32 in an f32-hardened device module"

    _F64_ATTRS = {"float64", "double"}
    _F64_BASES = {"np", "numpy", "onp", "torch"}
    _TF32_PRECISIONS = {"high", "medium"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.is_device:
            return
        allow = self._allowlist_for(ctx)
        parents = _walk_parents(ctx.tree)
        for node in ast.walk(ctx.tree):
            hit = self._f64_hit(node)
            tf32 = hit is None and self._tf32_hit(node)
            if hit is None and not tf32:
                continue
            scope = self._enclosing_scope_names(node, parents)
            if scope & allow:
                continue
            if tf32:
                yield ctx.finding(
                    self.id, node,
                    "TF32 switched on in an f32-hardened device module: it rounds "
                    "every f32 matmul input to a 10-bit mantissa, which the "
                    "reference's f32 numerics never do; leave TF32 off",
                )
            else:
                yield ctx.finding(
                    self.id, node,
                    f"{hit} in an f32-hardened device module: f64 widens the whole "
                    "computation and runs at a fraction of the card's f32 rate; "
                    "cast at the host boundary or add the function to the "
                    "HOST_BOUNDARY_F64 registry",
                )

    def _f64_hit(self, node: ast.AST) -> str | None:
        if isinstance(node, ast.Attribute) and node.attr in self._F64_ATTRS:
            chain = _attr_chain(node)
            if chain and (chain[0] in self._F64_BASES or "numpy" in chain[:-1]):
                return ".".join(chain)
            return None
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "double"
            and _attr_chain(node.func)[:1] != ["torch"]
        ):
            return ".double()"
        if isinstance(node, ast.Constant) and node.value == "float64":
            return "'float64'"
        return None

    def _tf32_hit(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                chain = _attr_chain(target)
                value = node.value
                if chain[-1:] == ["allow_tf32"] and not (
                    isinstance(value, ast.Constant) and value.value is False
                ):
                    return True
                if (
                    chain[-1:] == ["fp32_precision"]
                    and isinstance(value, ast.Constant)
                    and value.value == "tf32"
                ):
                    return True
            return False
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            return (
                chain[-1:] == ["set_float32_matmul_precision"]
                and bool(node.args)
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in self._TF32_PRECISIONS
            )
        return False

    def _allowlist_for(self, ctx: ModuleContext) -> set[str]:
        path = ctx.path.replace("\\", "/")
        for suffix, funcs in ctx.config.host_boundary_f64.items():
            if path.endswith(suffix):
                return set(funcs)
        return set()

    def _enclosing_scope_names(
        self, node: ast.AST, parents: dict[ast.AST, ast.AST]
    ) -> set[str]:
        names: set[str] = set()
        for anc in _ancestors(node, parents):
            if isinstance(anc, _Scoped):
                names.add(anc.name)
        return names


class TPU004StrayDebugOutput(Rule):
    id = "TPU004"
    title = "stray debug output"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id in ("print", "breakpoint"):
                yield ctx.finding(
                    self.id, node,
                    f"{node.func.id}() in package code: route through "
                    "optuna_tpu_torch.logging (or move the surface into cli.py)",
                )
            else:
                chain = _attr_chain(node.func)
                if chain[-2:] == ["debug", "print"] or chain[-2:] == ["pdb", "set_trace"]:
                    yield ctx.finding(
                        self.id, node,
                        f"{'.'.join(chain)} left in package code: debug taps "
                        "stall the run; remove before landing",
                    )
