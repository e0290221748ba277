"""graphlint configuration (PyTorch port): defaults, ``[tool.graphlint-torch]``.

Path semantics: every pattern is matched against the *resolved posix path*
of the file, so configs behave the same no matter which directory the
runner is invoked from. A pattern matches when it is a path suffix, a
directory prefix of a suffix (``optuna_tpu_torch/_lint`` covers the
subtree), or an ``fnmatch`` glob.

The port's project settings are the module constants below
(:data:`DEFAULT_EXCLUDE`, :data:`DEFAULT_OVERRIDES`, and the registry's
device paths). ``load_config`` applies them to any pyproject.toml, and a
``[tool.graphlint-torch]`` table there replaces them key by key::

    [tool.graphlint-torch]
    exclude = ["optuna_tpu_torch/_lint"]          # skip entirely
    disable = []                                  # rule ids off everywhere
    device-paths = ["optuna_tpu_torch/ops/", ...] # override device classification

    [[tool.graphlint-torch.overrides]]            # relaxed profile for a subtree
    paths = ["tests", "scripts"]
    disable = ["TPU004", "PY001"]

The JAX package's ``[tool.graphlint]`` table is never read here. A bare
``Config()`` (the CLI's ``--no-config``) carries the registry defaults and
no excludes or overrides.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import Mapping, Sequence

from optuna_tpu_torch._lint import registry


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _path_matches(path: str, pattern: str) -> bool:
    """True if ``pattern`` selects ``path`` (suffix / subtree / glob)."""
    path = _norm(path)
    pattern = _norm(pattern).rstrip("/")
    if not pattern:
        return False
    if path == pattern or path.endswith("/" + pattern):
        return True
    if ("/" + path + "/").find("/" + pattern + "/") != -1:
        return True
    if fnmatch.fnmatch(path, pattern) or fnmatch.fnmatch(path, "*/" + pattern):
        return True
    return False


def _device_path_matches(path: str, pattern: str) -> bool:
    # Device patterns keep their trailing slash ("subtree") distinction.
    path = _norm(path)
    pattern = _norm(pattern)
    if pattern.endswith("/"):
        return ("/" + pattern) in ("/" + path)
    return path.endswith(pattern)


@dataclasses.dataclass(frozen=True)
class PathOverride:
    paths: tuple[str, ...]
    disable: tuple[str, ...] = ()
    enable: tuple[str, ...] = ()


#: The pyproject table the port reads (``[tool.<TABLE>]``).
TABLE = "graphlint-torch"

#: The linter does not lint itself (its CLI prints findings and its rule
#: sources quote the very patterns they hunt), and the lint fixtures trip
#: rules by design — that is their job.
DEFAULT_EXCLUDE: tuple[str, ...] = ("optuna_tpu_torch/_lint", "tests/fixtures/lint_torch")

#: The command-line surface prints to stdout by design; outside the
#: package, tests assert on broad excepts and print freely, and scripts,
#: ``chip_smoke.py`` and ``bench.py`` are operator tooling.
DEFAULT_OVERRIDES: tuple[PathOverride, ...] = (
    PathOverride(paths=("optuna_tpu_torch/cli.py",), disable=("TPU004",)),
    PathOverride(
        paths=("tests", "scripts", "chip_smoke.py", "bench.py"),
        disable=("TPU001", "TPU003", "TPU004", "PY001"),
    ),
)


@dataclasses.dataclass(frozen=True)
class Config:
    disable: tuple[str, ...] = ()
    enable: tuple[str, ...] = ()  # non-empty => only these rule ids run
    exclude: tuple[str, ...] = ()
    overrides: tuple[PathOverride, ...] = ()
    device_paths: tuple[str, ...] = registry.DEVICE_MODULE_PATHS
    device_programs: Mapping[str, Mapping[str, str]] = dataclasses.field(
        default_factory=lambda: registry.DEVICE_PROGRAMS
    )
    host_boundary_f64: Mapping[str, Mapping[str, str]] = dataclasses.field(
        default_factory=lambda: registry.HOST_BOUNDARY_F64
    )
    sto001_targets: tuple[tuple[str, str, str], ...] = registry.STO001_TARGETS
    sto001_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.REPLAY_UNSAFE_REGISTRY
    )
    exe001_targets: tuple[tuple[str, str, str], ...] = registry.EXE001_TARGETS
    exe001_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.NON_FINITE_POLICY_REGISTRY
    )
    smp001_targets: tuple[tuple[str, str, str], ...] = registry.SMP001_TARGETS
    smp001_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.FALLBACK_POLICY_REGISTRY
    )
    obs002_targets: tuple[tuple[str, str, str], ...] = registry.OBS002_TARGETS
    obs002_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.FLIGHT_EVENT_REGISTRY
    )
    obs003_targets: tuple[tuple[str, str, str], ...] = registry.OBS003_TARGETS
    obs003_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.DEVICE_STAT_REGISTRY
    )
    obs004_targets: tuple[tuple[str, str, str], ...] = registry.OBS004_TARGETS
    obs004_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.HEALTH_CHECK_REGISTRY
    )
    obs005_targets: tuple[tuple[str, str, str], ...] = registry.OBS005_TARGETS
    obs005_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.SLO_REGISTRY
    )
    srv001_targets: tuple[tuple[str, str, str], ...] = registry.SRV001_TARGETS
    srv001_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.SHED_POLICY_REGISTRY
    )
    act001_targets: tuple[tuple[str, str, str], ...] = registry.ACT001_TARGETS
    act001_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.AUTOPILOT_ACTION_REGISTRY
    )
    flt001_targets: tuple[tuple[str, str, str], ...] = registry.FLT001_TARGETS
    flt001_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.FLEET_EVENT_REGISTRY
    )
    flt002_targets: tuple[tuple[str, str, str], ...] = registry.FLT002_TARGETS
    flt002_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.LEASE_EVENT_REGISTRY
    )
    ckpt001_targets: tuple[tuple[str, str, str], ...] = registry.CKPT001_TARGETS
    ckpt001_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.CHECKPOINT_EVENT_REGISTRY
    )
    smp002_paths: tuple[str, ...] = registry.SMP002_SAMPLER_PATHS
    smp002_helper: str = registry.SMP002_CHOLESKY_HELPER
    sto002_paths: tuple[str, ...] = ("optuna_tpu_torch/storages/",)
    conc001_paths: tuple[str, ...] = ("optuna_tpu_torch/",)
    conc002_paths: tuple[str, ...] = registry.CONC002_HOT_PATHS
    conc003_entrypoints: tuple[tuple[str, str, str], ...] = (
        registry.CONC003_THREAD_ENTRYPOINTS
    )
    conc004_targets: tuple[tuple[str, str, str], ...] = registry.CONC004_TARGETS
    conc004_registry: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: registry.LOCKSAN_REGISTRY
    )
    base_dir: str | None = None  # dir containing the config file, for display paths

    def is_excluded(self, path: str) -> bool:
        return any(_path_matches(path, pat) for pat in self.exclude)

    def is_device_path(self, path: str) -> bool:
        return any(_device_path_matches(path, pat) for pat in self.device_paths)

    def rule_enabled(self, rule_id: str, path: str) -> bool:
        from optuna_tpu_torch._lint.engine import BAD_PRAGMA_RULE, PARSE_ERROR_RULE

        # An `enable` allowlist selects *rules to run*; the engine
        # diagnostics (unparsable file, malformed pragma) must survive it or
        # a syntax-broken file would lint clean. Explicit disable/overrides
        # still silence them.
        diagnostics = (PARSE_ERROR_RULE, BAD_PRAGMA_RULE)
        if self.enable and rule_id not in self.enable and rule_id not in diagnostics:
            return False
        enabled = rule_id not in self.disable
        for override in self.overrides:
            if any(_path_matches(path, pat) for pat in override.paths):
                if rule_id in override.disable:
                    enabled = False
                if rule_id in override.enable:
                    enabled = True
        return enabled


def _load_toml(path: str) -> dict:
    try:
        import tomllib  # Python >= 3.11
    except ImportError:
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ImportError:
            # Silently running with defaults would un-exclude/un-disable
            # whatever the project configured — fail loudly instead (the CLI
            # maps this to exit 2; --no-config opts into defaults).
            raise RuntimeError(
                f"cannot read {path}: no TOML parser available "
                "(Python < 3.11 needs the 'tomli' package; "
                "or pass --no-config to run with built-in defaults)"
            ) from None
    with open(path, "rb") as f:
        return tomllib.load(f)


def find_pyproject(start: str) -> str | None:
    """Walk up from ``start`` to the filesystem root looking for pyproject.toml."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        candidate = os.path.join(cur, "pyproject.toml")
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def load_config(pyproject_path: str | None) -> Config:
    """Build a Config from a pyproject.toml: the port's defaults, replaced key
    by key by a ``[tool.graphlint-torch]`` table. None gives a bare Config."""
    if pyproject_path is None:
        return Config()
    data = _load_toml(pyproject_path)
    table = data.get("tool", {}).get(TABLE, {})
    if not isinstance(table, dict):
        table = {}

    def strings(key: str, default: Sequence[str] = ()) -> tuple[str, ...]:
        val = table.get(key, table.get(key.replace("_", "-"), list(default)))
        if not isinstance(val, list):
            return tuple(default)
        return tuple(str(v) for v in val)

    overrides = list(DEFAULT_OVERRIDES) if "overrides" not in table else []
    for entry in table.get("overrides", ()):
        if not isinstance(entry, dict):
            continue
        paths = tuple(str(p) for p in entry.get("paths", ()))
        if not paths:
            continue
        overrides.append(
            PathOverride(
                paths=paths,
                disable=tuple(str(r) for r in entry.get("disable", ())),
                enable=tuple(str(r) for r in entry.get("enable", ())),
            )
        )
    return Config(
        disable=strings("disable"),
        enable=strings("enable"),
        exclude=strings("exclude", DEFAULT_EXCLUDE),
        overrides=tuple(overrides),
        device_paths=strings("device_paths", registry.DEVICE_MODULE_PATHS),
        base_dir=os.path.dirname(os.path.abspath(pyproject_path)),
    )
