"""graphlint command line for the PyTorch port: shared by
``python -m optuna_tpu_torch._lint`` and the ``optuna-tpu-torch-lint``
console script.

Exit codes: 0 clean, 1 findings, 2 usage/configuration error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

from optuna_tpu_torch._lint import all_rules, find_pyproject, load_config, registry, run_lint


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="optuna-tpu-torch-lint",
        description="AST-based invariant checker for device kernels and storage concurrency.",
    )
    parser.add_argument(
        "paths", nargs="*", default=["optuna_tpu_torch"],
        help="files or directories to lint (default: optuna_tpu_torch)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "github"), default="text",
        help="finding output format; 'github' emits ::error workflow "
        "annotations (default: text)",
    )
    parser.add_argument(
        "--config", default=None, metavar="PYPROJECT",
        help="pyproject.toml to read [tool.graphlint-torch] from "
        "(default: nearest one above the first path)",
    )
    parser.add_argument(
        "--no-config", action="store_true",
        help="ignore any pyproject.toml and run with built-in defaults",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also list findings silenced by pragmas (text format only)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="list every rule id with its title, and the rules that do not "
        "apply to an eager package with the reason, then exit",
    )
    return parser


def _list_rules() -> int:
    for rule in all_rules():
        print(f"{rule.id:<8} {rule.title}")
    for rule_id, reason in sorted(registry.NOT_APPLICABLE_RULES.items()):
        print(f"{rule_id:<8} not applicable: {reason}")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        return _list_rules()
    if args.no_config:
        pyproject = None
    elif args.config is not None:
        pyproject = args.config
    else:
        pyproject = find_pyproject(args.paths[0])
    try:
        config = load_config(pyproject)
    except (OSError, ValueError, RuntimeError) as err:
        print(f"optuna-tpu-torch-lint: cannot load {pyproject}: {err}", file=sys.stderr)
        return 2
    try:
        result = run_lint(args.paths, config, all_rules())
    except OSError as err:
        print(f"optuna-tpu-torch-lint: {err}", file=sys.stderr)
        return 2

    if args.format == "github":
        # GitHub Actions workflow commands: one ::error per finding, so the
        # findings land as inline PR annotations. Newlines cannot appear in
        # the message portion of a workflow command; findings never contain
        # them, but escape defensively as the protocol requires (%0A/%0D,
        # and %25 so literal percent signs round-trip).
        for finding in result.findings:
            message = (
                f"{finding.rule} {finding.message}"
                .replace("%", "%25")
                .replace("\r", "%0D")
                .replace("\n", "%0A")
            )
            print(
                f"::error file={finding.path},line={finding.line},"
                f"col={finding.col},title=graphlint {finding.rule}::{message}"
            )
    elif args.format == "json":
        print(
            json.dumps(
                {
                    "findings": [f.as_dict() for f in result.findings],
                    "suppressed": len(result.suppressed),
                    "files_scanned": result.files_scanned,
                },
                indent=2,
            )
        )
    else:
        for finding in result.findings:
            print(finding.format())
        if args.show_suppressed:
            for finding, pragma in result.suppressed:
                print(f"[suppressed: {pragma.reason}] {finding.format()}")
        tail = (
            f"{len(result.findings)} finding(s), {len(result.suppressed)} suppressed, "
            f"{result.files_scanned} file(s) scanned"
        )
        print(tail, file=sys.stderr)
    return result.exit_code


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    raise SystemExit(main())
