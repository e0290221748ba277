"""graphlint for the PyTorch port (``optuna_tpu_torch/_lint``): the gate over
the port, a fixture self-test per rule, a drift test per sync rule, the
registry held to the JAX package's, and the linter's isolation from JAX.

The gate (``test_port_lint_clean``) runs the port's full rule set over
``optuna_tpu_torch`` with the repo's pyproject.toml: zero unsuppressed
findings, every suppression with a reason, and the known host reads of the
device programs found and suppressed with a reason that names ROADMAP H4.

Fixture self-tests prove each rule fires where a ``# EXPECT: RULE`` marker
says (exact rule id AND line number) and stays silent on the negative
twin. Module-rule fixtures live in ``tests/fixtures/lint_torch``; the sync
rules' fixtures are written into ``tmp_path``, one generated pair per rule.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from optuna_tpu_torch._lint import Config, all_rules, load_config, run_lint
from optuna_tpu_torch._lint import registry as lint_registry
from optuna_tpu_torch._lint.config import DEFAULT_EXCLUDE, DEFAULT_OVERRIDES, PathOverride

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO_ROOT, "optuna_tpu_torch")
PYPROJECT = os.path.join(REPO_ROOT, "pyproject.toml")
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "lint_torch")
FIX = "fixtures/lint_torch"

_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Z]{2,4}\d{3})")


def expected_markers(*paths: str) -> set[tuple[str, str, int]]:
    """(rule, filename, line) triples declared by ``# EXPECT: RULE`` comments."""
    out: set[tuple[str, str, int]] = set()
    for path in paths:
        with open(path) as f:
            for lineno, line in enumerate(f, start=1):
                for rule in _EXPECT_RE.findall(line):
                    out.add((rule, os.path.basename(path), lineno))
    return out


def found_triples(result) -> set[tuple[str, str, int]]:
    return {(f.rule, os.path.basename(f.path), f.line) for f in result.findings}


def fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


def _line_of(rel_path: str, needle: str) -> int:
    with open(os.path.join(REPO_ROOT, rel_path)) as f:
        hits = [i for i, line in enumerate(f, start=1) if needle in line]
    assert len(hits) == 1, (rel_path, needle, hits)
    return hits[0]


# --------------------------------------------------------------------- gate


@pytest.fixture(scope="module")
def port_scan():
    """One full scan of the port shared by the gate assertions."""
    return run_lint([PKG], load_config(PYPROJECT))


def test_port_lint_clean(port_scan):
    """THE gate: zero unsuppressed findings over the whole port."""
    formatted = "\n".join(f.format() for f in port_scan.findings)
    assert not port_scan.findings, f"graphlint found unsuppressed violations:\n{formatted}"
    assert port_scan.files_scanned > 100  # the walk really covered the package


def test_every_suppression_carries_a_reason(port_scan):
    assert port_scan.suppressed, "expected documented pragmas in the tree"
    for finding, pragma in port_scan.suppressed:
        assert pragma.reason.strip(), f"reason-less pragma suppressed {finding.format()}"
    by_rule: dict[str, int] = {}
    for finding, _ in port_scan.suppressed:
        by_rule[finding.rule] = by_rule.get(finding.rule, 0) + 1
    assert by_rule.get("PY001", 0) >= 82  # every broad handler names its boundary


def test_known_host_reads_are_found_and_suppressed_naming_h4(port_scan):
    """TPU001 sees the device programs' counted host reads; each is
    suppressed with a reason that points at ROADMAP H4, its repair."""
    known = {
        ("optuna_tpu_torch/ops/lbfgsb.py", _line_of("optuna_tpu_torch/ops/lbfgsb.py", "bool(torch.all(converged))")),
        ("optuna_tpu_torch/parallel/scan_loop.py", _line_of("optuna_tpu_torch/parallel/scan_loop.py", "finite = bool(finite_t)")),
        ("optuna_tpu_torch/parallel/scan_loop.py", _line_of("optuna_tpu_torch/parallel/scan_loop.py", "need_swap_t]).tolist()")),
    }
    tpu001 = {(f.path, f.line): p.reason for f, p in port_scan.suppressed if f.rule == "TPU001"}
    assert set(tpu001) == known
    assert all("H4" in reason for reason in tpu001.values())


def test_device_classification_names_only_the_port():
    """The port's device paths name the port's modules, ``ops/kernels/``
    included, and nothing of the JAX package."""
    config = load_config(PYPROJECT)
    assert not config.is_device_path(os.path.join(REPO_ROOT, "optuna_tpu", "ops", "qmc.py"))
    assert config.is_device_path(os.path.join(PKG, "ops", "kernels", "matern.py"))


# --------------------------------------------------- live rules on the tree


def test_smp002_sees_the_one_blessed_cholesky_ex():
    result = run_lint(
        [os.path.join(PKG, "samplers")], Config(enable=("SMP002",), base_dir=REPO_ROOT)
    )
    assert not result.findings, [f.format() for f in result.findings]
    blessed = [f for f, _ in result.suppressed if f.rule == "SMP002"]
    assert len(blessed) == 1 and blessed[0].path.endswith("samplers/_resilience.py")


def test_tpu003_allowlist_is_exactly_the_reviewed_host_boundaries():
    """Without the allowlist, every TPU003 hit of the port lies in a function
    the reference also allowlists, and every allowlisted function is hit:
    no float64 outside a reviewed boundary, and no stale entry."""
    config = dataclasses.replace(load_config(PYPROJECT), enable=("TPU003",), host_boundary_f64={})
    result = run_lint([PKG], config)
    assert result.findings
    hit: set[tuple[str, str]] = set()
    for finding in result.findings:
        with open(os.path.join(REPO_ROOT, finding.path)) as f:
            tree = ast.parse(f.read())
        names = {
            n.name
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.lineno <= finding.line <= n.end_lineno
        }
        allowed = lint_registry.HOST_BOUNDARY_F64.get(finding.path, {})
        assert names & set(allowed), finding.format()
        hit |= {(finding.path, name) for name in names & set(allowed)}
    listed = {(path, name) for path, funcs in lint_registry.HOST_BOUNDARY_F64.items() for name in funcs}
    assert hit == listed


def test_obs001_device_programs_are_tap_free():
    result = run_lint([PKG], dataclasses.replace(load_config(PYPROJECT), enable=("OBS001",)))
    assert not result.findings, [f.format() for f in result.findings]


# ------------------------------------------------------- fixture self-tests


def _device_config(name: str, **kwargs) -> Config:
    return Config(device_paths=(f"{FIX}/{name}",), base_dir=REPO_ROOT, **kwargs)


def _programs(name: str) -> dict:
    return {f"{FIX}/{name}": {"chunk_program": "fixture chunk", "Solver.run": "fixture solver"}}


RULE_CASES = [
    ("tpu001", lambda name: Config(device_programs=_programs(name), base_dir=REPO_ROOT)),
    (
        "obs001",
        lambda name: Config(device_programs={f"{FIX}/{name}": {"chunk_program": "fixture"}}, base_dir=REPO_ROOT),
    ),
    (
        "tpu003",
        lambda name: _device_config(
            name, host_boundary_f64={f"{FIX}/{name}": {"allowed_host_boundary": "fixture allowlist"}}
        ),
    ),
    ("tpu004", lambda name: Config(base_dir=REPO_ROOT)),
    ("py001", lambda name: Config(base_dir=REPO_ROOT)),
    ("sto002", lambda name: Config(base_dir=REPO_ROOT, sto002_paths=(f"{FIX}/",))),
    ("smp002", lambda name: Config(base_dir=REPO_ROOT, smp002_paths=(f"{FIX}/{name}",))),
    ("conc001", lambda name: Config(base_dir=REPO_ROOT, conc001_paths=(f"{FIX}/",))),
    ("conc002", lambda name: Config(base_dir=REPO_ROOT, conc002_paths=(f"{FIX}/",))),
    (
        "conc003",
        lambda name: Config(
            base_dir=REPO_ROOT, conc003_entrypoints=((f"{FIX}/{name}", "Worker._run", "fixture beat thread"),)
        ),
    ),
]


@pytest.mark.parametrize("stem,make_config", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_fires_exactly_where_expected(stem, make_config):
    pos = fixture(f"{stem}_pos.py")
    result = run_lint([pos], make_config(f"{stem}_pos.py"))
    expected = expected_markers(pos)
    assert expected, f"{pos} declares no EXPECT markers"
    assert found_triples(result) == expected


@pytest.mark.parametrize("stem,make_config", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_does_not_overfire(stem, make_config):
    neg = fixture(f"{stem}_neg.py")
    result = run_lint([neg], make_config(f"{stem}_neg.py"))
    assert not result.findings, [f.format() for f in result.findings]


def test_conc001_cycle_across_modules():
    """Each module alone is acyclic; only the package-wide merged graph
    closes the cycle."""
    tree = fixture("conc001_tree")
    members = [os.path.join(tree, n) for n in sorted(os.listdir(tree))]
    result = run_lint([tree], Config(base_dir=REPO_ROOT, conc001_paths=(f"{FIX}/conc001_tree",)))
    assert found_triples(result) == expected_markers(*members)
    for member in members:
        alone = run_lint([member], Config(base_dir=REPO_ROOT, conc001_paths=(f"{FIX}/",)))
        assert not alone.findings, [f.format() for f in alone.findings]


# ------------------------------------------------------------- sync rules

#: rule id -> (config field stem, canonical registry name, port module,
#: runtime symbols). The config fields are ``<stem>_registry`` and
#: ``<stem>_targets``.
SYNC_RULES = {
    "STO001": ("sto001", "REPLAY_UNSAFE_REGISTRY"),
    "EXE001": ("exe001", "NON_FINITE_POLICY_REGISTRY"),
    "SMP001": ("smp001", "FALLBACK_POLICY_REGISTRY"),
    "OBS002": ("obs002", "FLIGHT_EVENT_REGISTRY"),
    "OBS003": ("obs003", "DEVICE_STAT_REGISTRY"),
    "OBS004": ("obs004", "HEALTH_CHECK_REGISTRY"),
    "OBS005": ("obs005", "SLO_REGISTRY"),
    "SRV001": ("srv001", "SHED_POLICY_REGISTRY"),
    "ACT001": ("act001", "AUTOPILOT_ACTION_REGISTRY"),
    "FLT001": ("flt001", "FLEET_EVENT_REGISTRY"),
    "FLT002": ("flt002", "LEASE_EVENT_REGISTRY"),
    "CKPT001": ("ckpt001", "CHECKPOINT_EVENT_REGISTRY"),
    "CONC004": ("conc004", "LOCKSAN_REGISTRY"),
}

_FIXTURE_REGISTRY = {"alpha": "first entry", "beta": "second entry", "gamma": "third entry"}


def _write_sync_fixture(root, rule: str, drifted: bool) -> Config:
    """A two-copy vocabulary (plus, when drifted, a copy whose symbol is gone)
    under ``root``, and the Config that points ``rule`` at it."""
    root.mkdir()
    if drifted:
        copy_a = f'COPY_A = frozenset({{"alpha", "beta"}})  # EXPECT: {rule}\n'
        copy_b = f'BASE = {{"alpha", "beta"}}\nCOPY_B = BASE | {{"gamma", "delta"}}  # EXPECT: {rule}\n'
        (root / "copy_c.py").write_text(f"# EXPECT: {rule} (COPY_C is gone)\nOTHER = 1\n")
    else:
        copy_a = 'COPY_A = frozenset({"alpha", "beta", "gamma"})\n'
        copy_b = 'BASE = {"alpha": 1, "beta": 2}\nCOPY_B = dict(BASE) | {"gamma": 3}\n'
    (root / "copy_a.py").write_text(copy_a)
    (root / "copy_b.py").write_text(copy_b)
    targets = [("copy_a.py", "COPY_A", "fixture copy"), ("copy_b.py", "COPY_B", "fixture chaos matrix")]
    if drifted:
        targets.append(("copy_c.py", "COPY_C", "fixture copy that lost its symbol"))
    if rule == "CONC004":  # the call-site half: constructions outside the vocabulary
        name = "rogue.name" if drifted else "beta"
        marker = "  # EXPECT: CONC004" if drifted else ""
        (root / "user.py").write_text(f'from pkg import locksan\n\nLOCK = locksan.lock("{name}"){marker}\n')
    stem = SYNC_RULES[rule][0]
    return Config(
        enable=(rule,),
        base_dir=str(root),
        **{f"{stem}_registry": _FIXTURE_REGISTRY, f"{stem}_targets": tuple(targets)},
    )


@pytest.mark.parametrize("rule", sorted(SYNC_RULES))
def test_sync_rule_fixture_drift_detected(rule, tmp_path):
    root = tmp_path / "pos"
    config = _write_sync_fixture(root, rule, drifted=True)
    result = run_lint([str(root)], config)
    members = sorted(str(p) for p in root.iterdir())
    assert found_triples(result) == expected_markers(*members)
    messages = " | ".join(f.message for f in result.findings)
    assert "gamma" in messages and "delta" in messages and "not found" in messages


@pytest.mark.parametrize("rule", sorted(SYNC_RULES))
def test_sync_rule_fixture_in_sync_is_silent(rule, tmp_path):
    root = tmp_path / "neg"
    config = _write_sync_fixture(root, rule, drifted=False)
    result = run_lint([str(root)], config)
    assert not result.findings, [f.format() for f in result.findings]


@pytest.mark.parametrize("rule", sorted(SYNC_RULES))
def test_sync_rule_gate_rejects_drift_on_the_real_tree(rule):
    """Point the rule at the port's real copies with a registry holding an
    entry the code does not know: every copy must be reported as drifted."""
    stem, name = SYNC_RULES[rule]
    fat = dict(getattr(lint_registry, name))
    fat["made.up_entry"] = "made-up entry to prove the check is live"
    config = Config(enable=(rule,), base_dir=REPO_ROOT, **{f"{stem}_registry": fat})
    targets = getattr(config, f"{stem}_targets")
    result = run_lint([os.path.join(REPO_ROOT, suffix) for suffix, _, _ in targets], config)
    drifted = [f for f in result.findings if f.rule == rule]
    assert len(drifted) == len(targets), [f.format() for f in result.findings]
    assert all("made.up_entry" in f.message for f in drifted)


@pytest.mark.parametrize("rule", sorted(SYNC_RULES))
def test_sync_registry_matches_the_runtime_sets(rule):
    """The canonical registry equals the *runtime* value of every copy the
    rule compares statically."""
    import importlib

    stem, name = SYNC_RULES[rule]
    canonical = set(getattr(lint_registry, name))
    for suffix, symbol, _ in getattr(Config(), f"{stem}_targets"):
        module = importlib.import_module(suffix.removesuffix(".py").replace("/", "."))
        assert set(getattr(module, symbol)) == canonical, (suffix, symbol)


def test_conc003_registered_entrypoints_exist_and_drift_is_reported():
    from optuna_tpu_torch.storages._grpc.suggest_service import SuggestService
    from optuna_tpu_torch.storages._heartbeat import HeartbeatThread

    runtime = {
        "HeartbeatThread._record_periodically": HeartbeatThread._record_periodically,
        "SuggestService._refill_loop": SuggestService._refill_loop,
    }
    for _, qualname, _ in lint_registry.CONC003_THREAD_ENTRYPOINTS:
        assert callable(runtime[qualname])
    stale = Config(base_dir=REPO_ROOT, conc003_entrypoints=((f"{FIX}/conc003_neg.py", "Worker._gone", "stale"),))
    result = run_lint([fixture("conc003_neg.py")], stale)
    assert [f.rule for f in result.findings] == ["CONC003"]
    assert "not found" in result.findings[0].message


def test_tpu001_device_programs_drift_is_reported():
    """Every registered device program exists in its module, and a program
    the module no longer defines is itself a TPU001 finding."""
    files = [os.path.join(REPO_ROOT, suffix) for suffix in lint_registry.DEVICE_PROGRAMS]
    live = run_lint(files, Config(enable=("TPU001",), base_dir=REPO_ROOT))
    assert not [f for f in live.findings if "not found" in f.message]
    assert live.suppressed  # the scope reaches the known host reads
    programs = {f"{FIX}/tpu001_neg.py": {"chunk_program": "fixture", "gone_program": "stale registration"}}
    result = run_lint([fixture("tpu001_neg.py")], Config(device_programs=programs, base_dir=REPO_ROOT))
    assert [(f.rule, f.line) for f in result.findings] == [("TPU001", 1)]
    assert "gone_program" in result.findings[0].message


# -------------------------------------------------------- registry parity

#: The registry entries that differ from the JAX package's, with the reason.
#: Every other public name is equal once ``optuna_tpu/`` reads
#: ``optuna_tpu_torch/``.
REGISTRY_DIFFERENCES = {
    "DEVICE_MODULE_PATHS": "the hand-written CUDA kernels' wrappers live in ops/kernels/, in place of ops/pallas/",
    "DEVICE_PROGRAMS": "an eager package has no jit to find its device programs from, so they are named",
    "NOT_APPLICABLE_RULES": "TPU002 (jit recompile hazard) has no eager counterpart",
    "TELEMETRY_PHASE_REGISTRY": "the mirror of the port's telemetry.PHASES: the reference's phases (scan.chunk and "
    "scan.sync described as the eager chunk runs) and the port's own, telemetry.PORT_PHASES",
}


def _retarget(value):
    if isinstance(value, str):
        return value.replace("optuna_tpu/", "optuna_tpu_torch/")
    if isinstance(value, tuple):
        return tuple(_retarget(v) for v in value)
    if isinstance(value, dict):
        return {_retarget(k): _retarget(v) for k, v in value.items()}
    return value


def test_registry_equals_the_references_but_for_listed_differences():
    from optuna_tpu._lint import registry as ref_registry

    ref_names = {n for n in vars(ref_registry) if n.isupper()}
    port_names = {n for n in vars(lint_registry) if n.isupper()}
    assert port_names - ref_names == {"DEVICE_PROGRAMS", "NOT_APPLICABLE_RULES"}
    assert ref_names <= port_names
    for name in sorted(ref_names):
        if name in REGISTRY_DIFFERENCES:
            continue
        assert getattr(lint_registry, name) == _retarget(getattr(ref_registry, name)), name
    from optuna_tpu_torch import telemetry

    assert lint_registry.TELEMETRY_PHASE_REGISTRY.keys() == (
        ref_registry.TELEMETRY_PHASE_REGISTRY.keys() | telemetry.PORT_PHASES.keys()
    )
    assert lint_registry.DEVICE_MODULE_PATHS == tuple(
        p.replace("ops/pallas/", "ops/kernels/") for p in _retarget(ref_registry.DEVICE_MODULE_PATHS)
    )
    assert set(lint_registry.NOT_APPLICABLE_RULES) == {"TPU002"}
    ref_ids = {r.id for r in __import__("optuna_tpu._lint", fromlist=["all_rules"]).all_rules()}
    assert {r.id for r in all_rules()} == ref_ids - set(lint_registry.NOT_APPLICABLE_RULES)


# ------------------------------------------------------------------ pragmas


def test_pragma_with_reason_suppresses():
    result = run_lint([fixture("pragma_ok.py")], Config(base_dir=REPO_ROOT))
    assert not result.findings, [f.format() for f in result.findings]
    assert len(result.suppressed) == 2
    assert all(p.reason for _, p in result.suppressed)


def test_pragma_without_reason_is_rejected():
    result = run_lint([fixture("pragma_missing_reason.py")], Config(base_dir=REPO_ROOT))
    assert {f.rule for f in result.findings} == {"LNT001", "TPU004"}
    assert not result.suppressed


def test_enable_allowlist_keeps_engine_diagnostics():
    result = run_lint([fixture("broken_syntax.py")], Config(enable=("TPU001",), base_dir=REPO_ROOT))
    assert {f.rule for f in result.findings} == {"LNT000"}
    result = run_lint([fixture("broken_syntax.py")], Config(disable=("LNT000",), base_dir=REPO_ROOT))
    assert not result.findings


# ------------------------------------------------------- config + CLI surface


def test_load_config_applies_the_ports_defaults():
    config = load_config(PYPROJECT)
    assert config.exclude == DEFAULT_EXCLUDE
    assert config.overrides == DEFAULT_OVERRIDES
    assert config.device_paths == lint_registry.DEVICE_MODULE_PATHS
    assert config.is_excluded(os.path.join(PKG, "_lint", "engine.py"))
    assert config.is_excluded(fixture("tpu001_pos.py"))
    assert not config.rule_enabled("TPU004", os.path.join(PKG, "cli.py"))
    assert config.rule_enabled("TPU004", os.path.join(PKG, "study", "study.py"))
    assert not config.rule_enabled("PY001", os.path.join(REPO_ROOT, "chip_smoke.py"))
    assert config.rule_enabled("PY001", os.path.join(PKG, "testing", "fault_injection.py"))


def test_a_graphlint_torch_table_replaces_the_defaults_key_by_key(tmp_path):
    pyproject = tmp_path / "pyproject.toml"
    pyproject.write_text(
        textwrap.dedent(
            """
            [tool.graphlint]
            exclude = ["the_jax_table_is_never_read"]

            [tool.graphlint-torch]
            disable = ["PY001"]
            device-paths = ["mypkg/ops/"]

            [[tool.graphlint-torch.overrides]]
            paths = ["mypkg/cli.py"]
            disable = ["TPU004"]
            """
        )
    )
    config = load_config(str(pyproject))
    assert config.disable == ("PY001",)
    assert config.exclude == DEFAULT_EXCLUDE
    assert config.device_paths == ("mypkg/ops/",)
    assert config.overrides == (PathOverride(paths=("mypkg/cli.py",), disable=("TPU004",)),)
    assert config.base_dir == str(tmp_path)


def test_cli_json_format_exit_codes_and_rule_list(capsys):
    from optuna_tpu_torch._lint.cli import main

    rc = main([fixture("tpu004_pos.py"), "--no-config", "--format=json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {f["rule"] for f in payload["findings"]} == {"TPU004"}
    assert len(payload["findings"]) == 3

    rc = main([fixture("tpu004_neg.py"), "--no-config", "--format=json"])
    assert rc == 0 and json.loads(capsys.readouterr().out)["findings"] == []

    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.splitlines()
    ids = [line.split()[0] for line in listed]
    assert ids[:-1] == [r.id for r in all_rules()]
    assert listed[-1].startswith("TPU002") and "not applicable" in listed[-1]


def test_module_entrypoint_is_clean_and_imports_no_jax():
    """``python -m optuna_tpu_torch._lint optuna_tpu_torch`` exits 0 in a
    fresh interpreter that has imported neither ``jax`` nor ``optuna_tpu``."""
    script = textwrap.dedent(
        """
        import runpy, sys
        sys.argv = ["optuna-tpu-torch-lint", "optuna_tpu_torch"]
        try:
            runpy.run_module("optuna_tpu_torch._lint", run_name="__main__")
        except SystemExit as stop:
            code = stop.code
        leaked = sorted(
            m for m in sys.modules
            if m in ("jax", "optuna_tpu") or m.startswith(("jax.", "optuna_tpu."))
        )
        print("RESULT", code, leaked)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO_ROOT, capture_output=True, text=True, timeout=180
    )
    assert "RESULT 0 []" in proc.stdout, proc.stdout + proc.stderr
