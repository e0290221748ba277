"""graphlint engine: finding model, pragma suppression, rule protocol, runner.

Stdlib-only by design (``ast`` + ``tokenize``): the lint gate must run in
tier-1 CI and on a bare GPU host without pulling a linter toolchain. Rules
are small classes; the engine owns file walking, parsing, pragma handling,
and suppression so rules only ever look at an AST.

Suppression pragma grammar (the *reason is mandatory*)::

    x = bad_thing()  # graphlint: ignore[TPU001] -- host boundary, reviewed

    # graphlint: ignore[STO002,PY001] -- lock order proven acyclic by test X
    with a, b: ...

A pragma on its own line covers the next non-blank, non-comment line; a
trailing pragma covers its own line. A pragma without a ``-- reason`` (or
with an empty reason) suppresses nothing and is itself reported as LNT001.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Iterable, Sequence

#: Rule id for engine-level findings (unparsable file).
PARSE_ERROR_RULE = "LNT000"
#: Rule id for malformed suppression pragmas (missing reason, bad grammar).
BAD_PRAGMA_RULE = "LNT001"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a file/line/column."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Pragma:
    line: int
    rules: tuple[str, ...]
    reason: str
    own_line: bool


_PRAGMA_RE = re.compile(
    r"graphlint:\s*ignore\s*\[(?P<rules>[^\]]*)\]\s*(?:--\s*(?P<reason>.*?))?\s*$"
)


def parse_pragmas(source: str, path: str) -> tuple[list[Pragma], list[Finding]]:
    """Extract suppression pragmas from comments; malformed ones become findings."""
    good: list[Pragma] = []
    bad: list[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return good, bad  # the parse-error finding covers this file already
    lines = source.splitlines()
    for tok in tokens:
        # Only 'graphlint:' marks a pragma; prose like "graphlint rule X
        # checks this" must not be mistaken for a malformed suppression.
        if tok.type != tokenize.COMMENT or not re.search(r"graphlint\s*:", tok.string):
            continue
        line_no = tok.start[0]
        m = _PRAGMA_RE.search(tok.string)
        if m is None:
            bad.append(
                Finding(
                    BAD_PRAGMA_RULE, path, line_no, tok.start[1] + 1,
                    "unparsable graphlint pragma "
                    "(grammar: '# graphlint: ignore[RULE,...] -- reason')",
                )
            )
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",") if r.strip())
        reason = (m.group("reason") or "").strip()
        if not rules or not reason:
            bad.append(
                Finding(
                    BAD_PRAGMA_RULE, path, line_no, tok.start[1] + 1,
                    "graphlint pragma rejected: a non-empty '-- reason' is required"
                    if rules
                    else "graphlint pragma rejected: no rule ids inside [...]",
                )
            )
            continue
        text_before = lines[line_no - 1][: tok.start[1]] if line_no <= len(lines) else ""
        good.append(Pragma(line_no, rules, reason, own_line=not text_before.strip()))
    return good, bad


def _covered_lines(pragma: Pragma, source_lines: Sequence[str]) -> set[int]:
    covered = {pragma.line}
    if pragma.own_line:
        for idx in range(pragma.line, len(source_lines)):
            stripped = source_lines[idx].strip()
            if stripped and not stripped.startswith("#"):
                covered.add(idx + 1)
                break
    return covered


class ModuleContext:
    """Everything a per-module rule may look at for one file."""

    def __init__(self, path: str, display_path: str, source: str, tree: ast.Module, config):
        self.path = path  # resolved posix path, used for classification
        self.display_path = display_path  # what findings report
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.config = config

    @property
    def is_device(self) -> bool:
        return self.config.is_device_path(self.path)

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule,
            self.display_path,
            getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0) + 1,
            message,
        )


class Rule:
    """Per-module rule: ``check`` yields findings for one file."""

    id: str = ""
    title: str = ""

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError


class ProjectRule(Rule):
    """Cross-file rule: sees every scanned module at once."""

    def check_project(self, modules: Sequence[ModuleContext], config) -> Iterable[Finding]:
        raise NotImplementedError

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        return ()


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    suppressed: list[tuple[Finding, Pragma]]
    files_scanned: int

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0


def iter_python_files(paths: Sequence[str], config) -> list[str]:
    out: list[str] = []
    seen: set[str] = set()  # overlapping inputs (dir + nested file) dedupe

    def add(full: str) -> None:
        full = os.path.abspath(full)
        if full not in seen and full.endswith(".py") and not config.is_excluded(full):
            seen.add(full)
            out.append(full)

    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            add(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d
                for d in dirs
                if d != "__pycache__" and not config.is_excluded(os.path.join(root, d))
            )
            for name in sorted(files):
                add(os.path.join(root, name))
    return out


def _display_path(path: str, config) -> str:
    base = config.base_dir or os.getcwd()
    try:
        rel = os.path.relpath(path, base)
    except ValueError:  # different drive (windows) — keep absolute
        return path.replace(os.sep, "/")
    if rel.startswith(".."):
        return path.replace(os.sep, "/")
    return rel.replace(os.sep, "/")


#: Parse results shared across ``run_lint`` calls, keyed by absolute path
#: and invalidated by ``(mtime_ns, size)``. One scan parses each file once
#: and shares the AST across every rule; REPEATED scans (the tier-1 gate +
#: the per-rule live-drift tests each rescan the package) skip the parse
#: and tokenize work entirely. Entries are ``(stat key, source, tree,
#: pragmas, bad-pragma (line, col, message) triples)`` — everything stored
#: is display-path-independent, so one cache serves any config/base_dir.
#: Rules receive the SAME tree object on every scan and must not mutate it.
_PARSE_CACHE: dict[str, tuple[tuple[int, int], str, ast.Module, list, list]] = {}


def clear_parse_cache() -> None:
    """Drop every cached parse (tests; long-lived daemons after bulk edits)."""
    _PARSE_CACHE.clear()


def run_lint(paths: Sequence[str], config, rules: Sequence[Rule] | None = None) -> LintResult:
    """Lint ``paths`` (files or directories) under ``config`` with ``rules``.

    Returns every unsuppressed finding, sorted, plus the suppressed pairs so
    callers can audit what the pragmas hid.
    """
    if rules is None:
        from optuna_tpu_torch._lint import all_rules

        rules = all_rules()
    module_rules = [r for r in rules if not isinstance(r, ProjectRule)]
    project_rules = [r for r in rules if isinstance(r, ProjectRule)]

    files = iter_python_files(paths, config)
    contexts: list[ModuleContext] = []
    raw: list[Finding] = []
    pragma_map: dict[str, list[Pragma]] = {}

    for path in files:
        display = _display_path(path, config)
        try:
            stat = os.stat(path)
        except OSError as err:
            if config.rule_enabled(PARSE_ERROR_RULE, path):
                raw.append(Finding(PARSE_ERROR_RULE, display, 1, 1, f"unreadable file: {err}"))
            continue
        stat_key = (stat.st_mtime_ns, stat.st_size)
        cached = _PARSE_CACHE.get(path)
        if cached is not None and cached[0] == stat_key:
            _, source, tree, pragmas, bad_raw = cached
        else:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    source = f.read()
            except (OSError, UnicodeDecodeError) as err:
                if config.rule_enabled(PARSE_ERROR_RULE, path):
                    raw.append(
                        Finding(PARSE_ERROR_RULE, display, 1, 1, f"unreadable file: {err}")
                    )
                continue
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as err:
                if config.rule_enabled(PARSE_ERROR_RULE, path):
                    raw.append(
                        Finding(
                            PARSE_ERROR_RULE, display, err.lineno or 1, (err.offset or 0) + 1,
                            f"syntax error: {err.msg}",
                        )
                    )
                continue
            pragmas, bad_pragmas = parse_pragmas(source, display)
            bad_raw = [(f.line, f.col, f.message) for f in bad_pragmas]
            _PARSE_CACHE[path] = (stat_key, source, tree, pragmas, bad_raw)
        if config.rule_enabled(BAD_PRAGMA_RULE, path):
            raw.extend(
                Finding(BAD_PRAGMA_RULE, display, line, col, message)
                for line, col, message in bad_raw
            )
        pragma_map[display] = pragmas
        ctx = ModuleContext(path, display, source, tree, config)
        contexts.append(ctx)
        for rule in module_rules:
            if config.rule_enabled(rule.id, path):
                raw.extend(rule.check(ctx))

    for rule in project_rules:
        raw.extend(rule.check_project(contexts, config))

    findings: list[Finding] = []
    suppressed: list[tuple[Finding, Pragma]] = []
    line_cache: dict[str, dict[int, list[Pragma]]] = {}
    for ctx in contexts:
        per_line: dict[int, list[Pragma]] = {}
        for pragma in pragma_map.get(ctx.display_path, ()):
            for line in _covered_lines(pragma, ctx.lines):
                per_line.setdefault(line, []).append(pragma)
        line_cache[ctx.display_path] = per_line
    for finding in raw:
        match = None
        if finding.rule not in (PARSE_ERROR_RULE, BAD_PRAGMA_RULE):
            for pragma in line_cache.get(finding.path, {}).get(finding.line, ()):
                if finding.rule in pragma.rules:
                    match = pragma
                    break
        if match is not None:
            suppressed.append((finding, match))
        else:
            findings.append(finding)
    findings.sort(key=Finding.sort_key)
    return LintResult(findings=findings, suppressed=suppressed, files_scanned=len(contexts))
