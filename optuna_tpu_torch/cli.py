"""Command-line interface (port of ``optuna_tpu/cli.py``).

Parity target: ``optuna/cli.py:814-977`` — 11 subcommands including shell
level ``ask``/``tell`` for driving distributed loops from scripts, with
json/table/yaml output formats (``:156-273``), over the port's storages
(``storage-upgrade`` walks :meth:`RDBStorage.upgrade`), plus the
``trajectory`` rendering of the committed perf ledger
(``BENCH_TRAJECTORY.json``, stdlib only).

The observability commands read the port's own modules: ``metrics``
(telemetry), ``trace`` (the flight recorder), ``doctor`` (the study doctor
over ``--storage``, or ``/health.json`` endpoints), ``autopilot`` (the
act-mode audit mirror in ``--storage``, or ``/autopilot.json``) and
``slo``, with the reference's flags and output shapes.

Entry points: ``python -m optuna_tpu_torch.cli ...`` or the
``optuna-tpu-torch`` console script. ``ask`` runs the study's sampler, which
samples on the card unless its ``--sampler-kwargs`` say ``"device": "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Sequence

from optuna_tpu_torch.exceptions import CLIUsageError, OptunaTPUError


def _storage(args: argparse.Namespace):
    from optuna_tpu_torch.storages import get_storage

    if not args.storage:
        raise CLIUsageError("--storage is required for this command.")
    return get_storage(args.storage)


def _format_output(rows: list[dict[str, Any]], fmt: str) -> str:
    if fmt == "json":
        return json.dumps(rows, default=str)
    if fmt == "yaml":
        out = []
        for row in rows:
            out.append("- " + "\n  ".join(f"{k}: {v}" for k, v in row.items()))
        return "\n".join(out)
    # table
    if not rows:
        return "(empty)"
    cols = list(rows[0].keys())
    widths = {c: max(len(str(c)), *(len(str(r.get(c, ""))) for r in rows)) for c in cols}
    lines = [
        " | ".join(str(c).ljust(widths[c]) for c in cols),
        "-+-".join("-" * widths[c] for c in cols),
    ]
    for r in rows:
        lines.append(" | ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def _trial_row(t) -> dict[str, Any]:
    return {
        "number": t.number,
        "state": t.state.name,
        "values": t.values,
        "datetime_start": t.datetime_start,
        "datetime_complete": t.datetime_complete,
        "params": json.dumps(t.params, default=str),
    }


def _cmd_create_study(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    directions = None
    if args.directions:
        directions = args.directions
    study = optuna_tpu_torch.create_study(
        storage=_storage(args),
        study_name=args.study_name,
        direction=None if directions else args.direction,
        directions=directions,
        load_if_exists=args.skip_if_exists,
    )
    print(study.study_name)


def _cmd_delete_study(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    optuna_tpu_torch.delete_study(study_name=args.study_name, storage=_storage(args))


def _cmd_studies(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    summaries = optuna_tpu_torch.get_all_study_summaries(_storage(args))
    rows = [
        {
            "name": s.study_name,
            "direction": ",".join(d.name for d in s.directions),
            "n_trials": s.n_trials,
            "datetime_start": s.datetime_start,
        }
        for s in summaries
    ]
    print(_format_output(rows, args.format))


def _cmd_study_names(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    names = [
        {"name": s.study_name}
        for s in optuna_tpu_torch.get_all_study_summaries(_storage(args))
    ]
    print(_format_output(names, args.format))


def _cmd_trials(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    study = optuna_tpu_torch.load_study(study_name=args.study_name, storage=_storage(args))
    print(_format_output([_trial_row(t) for t in study.trials], args.format))


def _cmd_best_trial(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    study = optuna_tpu_torch.load_study(study_name=args.study_name, storage=_storage(args))
    print(_format_output([_trial_row(study.best_trial)], args.format))


def _cmd_best_trials(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    study = optuna_tpu_torch.load_study(study_name=args.study_name, storage=_storage(args))
    print(_format_output([_trial_row(t) for t in study.best_trials], args.format))


def _cmd_study_set_user_attr(args: argparse.Namespace) -> None:
    import optuna_tpu_torch

    study = optuna_tpu_torch.load_study(study_name=args.study_name, storage=_storage(args))
    study.set_user_attr(args.key, json.loads(args.value) if args.json_value else args.value)


def _cmd_storage_upgrade(args: argparse.Namespace) -> None:
    # Walk the migration chain to head (reference keeps alembic migrations,
    # we keep version_info + per-step SQL batches).
    from optuna_tpu_torch.storages._rdb.storage import RDBStorage

    storage = RDBStorage(args.storage, skip_compatibility_check=True)
    before = storage.get_current_version()
    storage.upgrade()
    after = storage.get_current_version()
    if before == after:
        print(f"Storage is up to date (schema version {after}).")
    else:
        print(f"Upgraded storage schema {before} -> {after}.")


def _parse_sampler(args: argparse.Namespace):
    if not args.sampler:
        return None
    import optuna_tpu_torch.samplers as samplers_mod

    cls = getattr(samplers_mod, args.sampler, None)
    if cls is None:
        raise CLIUsageError(f"Unknown sampler: {args.sampler}")
    kwargs = json.loads(args.sampler_kwargs) if args.sampler_kwargs else {}
    return cls(**kwargs)


def _cmd_ask(args: argparse.Namespace) -> None:
    """Create (or load) the study, ask one trial, print its number + params
    (reference ``cli.py:655``)."""
    import optuna_tpu_torch

    directions = args.directions if args.directions else None
    try:
        study = optuna_tpu_torch.load_study(
            study_name=args.study_name, storage=_storage(args), sampler=_parse_sampler(args)
        )
    except KeyError:
        study = optuna_tpu_torch.create_study(
            storage=_storage(args),
            study_name=args.study_name,
            direction=None if directions else args.direction,
            directions=directions,
            load_if_exists=True,
            sampler=_parse_sampler(args),
        )
    search_space = (
        {
            name: optuna_tpu_torch.distributions.json_to_distribution(json.dumps(d))
            for name, d in json.loads(args.search_space).items()
        }
        if args.search_space
        else None
    )
    trial = study.ask(fixed_distributions=search_space)
    print(json.dumps({"number": trial.number, "params": trial.params}, default=str))


def _cmd_tell(args: argparse.Namespace) -> None:
    """Report a finished trial by number (reference ``cli.py:760``)."""
    import optuna_tpu_torch
    from optuna_tpu_torch.trial import TrialState

    study = optuna_tpu_torch.load_study(study_name=args.study_name, storage=_storage(args))
    state = None
    if args.state:
        state = TrialState[args.state.upper()]
    values = [float(v) for v in args.values] if args.values else None
    study.tell(
        args.trial_number,
        values=values if values is None or len(values) > 1 else values[0],
        state=state,
        skip_if_finished=args.skip_if_finished,
    )


#: The reference's commands the port does not carry yet, with the ROADMAP
#: item that owns each: none.
NOT_YET_PORTED: dict[str, tuple[str, str]] = {}


def _cmd_metrics(args: argparse.Namespace) -> None:
    """Dump the telemetry registry (see :mod:`optuna_tpu_torch.telemetry`).

    Without ``--endpoint`` the dump is this process's registry — empty unless
    ``OPTUNA_TPU_TORCH_TELEMETRY`` was set or the invoked workflow recorded
    something; with ``--endpoint`` it is fetched from a serving process
    (``telemetry.serve_metrics``), which is where a live study's numbers
    actually accumulate.
    """
    from optuna_tpu_torch import telemetry

    if args.endpoint:
        import urllib.request

        base = args.endpoint.rstrip("/")
        path = "/metrics.json" if args.format == "json" else "/metrics"
        if base.endswith("/metrics.json") or base.endswith("/metrics"):
            # A full path pins the format; a silent mismatch would hand
            # Prometheus text to a JSON consumer (or vice versa).
            implied = "json" if base.endswith("/metrics.json") else "prom"
            if implied != args.format:
                raise CLIUsageError(
                    f"endpoint path {base!r} serves {implied!r} but "
                    f"--format={args.format}; pass the matching --format or "
                    "give the base URL (e.g. http://host:9090) and let the "
                    "format pick the path."
                )
            url = base
        else:
            url = base + path
        with urllib.request.urlopen(url, timeout=10) as response:
            print(response.read().decode(), end="")
        return
    if args.format == "json":
        # export_snapshot: the registry plus the flight recorder's per-label
        # jit compile/retrace totals — host phases, device.* stat gauges and
        # compile counts on one surface (mirrors /metrics.json).
        print(json.dumps(telemetry.export_snapshot(), sort_keys=True))
    else:
        print(telemetry.render_prometheus(), end="")


def _cmd_trace(args: argparse.Namespace) -> None:
    """Dump the flight recorder's timeline (see :mod:`optuna_tpu_torch.flight`).

    ``--format=chrome`` (default) emits Chrome trace-event JSON — open it in
    Perfetto or ``chrome://tracing``; ``--format=events`` emits the raw
    structured event list. ``--trial N`` filters the dump to one trial's
    events plus their parent spans — the single-trial postmortem slice,
    instead of the whole ring. Without ``--endpoint`` the dump is this
    process's recorder — empty unless ``OPTUNA_TPU_TORCH_FLIGHT`` was set; with
    ``--endpoint`` it is fetched from a serving process's ``/trace.json``
    (``telemetry.serve_metrics``), which is where a live fleet's
    stitched timeline actually accumulates. ``--output`` writes to a file
    instead of stdout (the natural hand-off to a Perfetto tab).
    """
    from optuna_tpu_torch import flight

    if args.endpoint:
        import urllib.request

        base = args.endpoint.rstrip("/")
        url = base if base.endswith("/trace.json") else base + "/trace.json"
        if args.format != "chrome":
            raise CLIUsageError(
                "--endpoint serves Chrome trace JSON only; drop --format or "
                "pass --format=chrome."
            )
        with urllib.request.urlopen(url, timeout=10) as response:
            payload = response.read().decode()
        if args.trial is not None:
            payload = json.dumps(
                flight.filter_chrome_trace(json.loads(payload), args.trial)
            )
    else:
        if args.format == "chrome":
            flight.sample_device_gauges()  # before the read, so it exports
        events = flight.events()
        if args.trial is not None:
            events = flight.filter_trial(events, args.trial)
        if args.format == "chrome":
            payload = json.dumps(flight.chrome_trace(events))
        else:
            payload = json.dumps([ev.to_dict() for ev in events])
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(payload)
            f.write("\n")
        print(args.output)
    else:
        print(payload)


def _fetch_hub_report(endpoint: str, study_name: str) -> dict:
    """One hub's ``/health.json`` report for one study, or raise."""
    import urllib.request

    base = endpoint.rstrip("/")
    url = base if base.endswith("/health.json") else base + "/health.json"
    with urllib.request.urlopen(url, timeout=10) as response:
        payload = json.loads(response.read().decode())
    if payload.get("enabled") is False:
        # The structured not-armed payload (vs a 404 for a typo'd
        # path): the process is reachable but has no storage to
        # aggregate fleet reports over.
        raise CLIUsageError(
            f"the endpoint {endpoint!r} doctor is not armed: "
            + payload.get("reason", "no health_source on that process")
        )
    reports = payload.get("reports", [])
    report = next((r for r in reports if r.get("study") == study_name), None)
    if report is None:
        known = sorted(r.get("study") for r in reports)
        raise CLIUsageError(
            f"endpoint {endpoint!r} serves no study named {study_name!r} "
            f"(it has: {known})."
        )
    return report


def _merge_hub_reports(
    by_hub: dict[str, dict], unreachable: list[str]
) -> dict:
    """Fold per-hub doctor reports into one fleet-wide report.

    Hubs share the journal storage, so each report is the same computation
    taken at a slightly different instant — the freshest one is the base.
    Findings are unioned by check id, each tagged with the hubs that raised
    it, so a verdict only one hub can see (e.g. the survivor that declared
    ``service.hub_dead``) is never lost to a staler base report.
    """
    base = max(by_hub.values(), key=lambda r: r.get("generated_unix", 0.0))
    merged = dict(base)
    findings: dict[str, dict] = {}
    seen_at: dict[str, list[str]] = {}
    for hub, report in sorted(by_hub.items()):
        for finding in report.get("findings", ()):
            check = finding.get("check", "?")
            findings.setdefault(check, dict(finding))
            seen_at.setdefault(check, []).append(hub)
    for check, finding in findings.items():
        finding["hubs"] = seen_at[check]
    merged["findings"] = [findings[c] for c in sorted(findings)]
    merged["healthy"] = not merged["findings"]
    merged["hub_endpoints"] = {
        "reachable": sorted(by_hub),
        "unreachable": sorted(unreachable),
    }
    return merged


def _cmd_doctor(args: argparse.Namespace) -> None:
    """The study doctor's report (see :mod:`optuna_tpu_torch.health`).

    Without ``--endpoint`` the study is loaded from ``--storage`` and the
    report computed in this process (the fleet view lives in the study's
    system attrs, so any worker or operator shell can run the doctor);
    with ``--endpoint`` the report is fetched from a serving process's
    ``/health.json`` (``telemetry.serve_metrics``). A single endpoint
    is that one hub's view; against a hub fleet pass every hub
    comma-separated (``--endpoint hub-a:8081,hub-b:8081``) and the reports
    are merged — findings unioned by check and tagged with the hubs that
    raised them, unreachable hubs listed rather than fatal (the survivors'
    ``service.hub_dead`` verdict is exactly what you came for).
    """
    from optuna_tpu_torch import health

    if args.endpoint:
        endpoints = [e.strip() for e in args.endpoint.split(",") if e.strip()]
        if len(endpoints) == 1:
            report = _fetch_hub_report(endpoints[0], args.study_name)
        else:
            by_hub: dict[str, dict] = {}
            unreachable: list[str] = []
            usage_errors: list[CLIUsageError] = []
            for endpoint in endpoints:
                try:
                    by_hub[endpoint] = _fetch_hub_report(
                        endpoint, args.study_name
                    )
                except CLIUsageError as err:
                    # Reachable but not serving this study / not armed:
                    # a configuration problem, not a dead hub.
                    usage_errors.append(err)
                except OSError:
                    unreachable.append(endpoint)
            if usage_errors:
                raise usage_errors[0]
            if not by_hub:
                raise CLIUsageError(
                    "no hub endpoint was reachable "
                    f"(tried: {sorted(unreachable)})."
                )
            report = _merge_hub_reports(by_hub, unreachable)
    else:
        storage = _storage(args)
        study_id = storage.get_study_id_from_name(args.study_name)
        report = health.health_report(
            storage, study_id, study_name=args.study_name
        )
    if args.format == "json":
        print(json.dumps(report, sort_keys=True))
    else:
        from optuna_tpu_torch import autopilot

        # "would act" column: when an autopilot policy is configured in
        # this process (OPTUNA_TPU_TORCH_AUTOPILOT / autopilot.enable()), each
        # finding shows the guarded action the control loop would take.
        would_act = (
            {check: autopilot.action_for(check) for check in health.HEALTH_CHECKS}
            if autopilot.enabled()
            else None
        )
        print(health.render_text(report, would_act=would_act))


def _cmd_autopilot(args: argparse.Namespace) -> None:
    """The autopilot's action log (see :mod:`optuna_tpu_torch.autopilot`).

    Without ``--endpoint`` the log is reconstructed from the study's
    ``autopilot:action:*`` system attrs in ``--storage`` (the act-mode
    audit mirror, so any operator shell can read what an unattended run
    did); with ``--endpoint`` it is fetched live from a serving process's
    ``/autopilot.json``, which additionally carries budget and cooldown
    clocks only the owning process knows.
    """
    from optuna_tpu_torch import autopilot

    if args.endpoint:
        import urllib.request

        base = args.endpoint.rstrip("/")
        url = base if base.endswith("/autopilot.json") else base + "/autopilot.json"
        with urllib.request.urlopen(url, timeout=10) as response:
            report = json.loads(response.read().decode())
        if args.study_name:
            report["autopilots"] = [
                p for p in report.get("autopilots", [])
                if p.get("study") == args.study_name
            ]
    else:
        if not args.study_name:
            raise CLIUsageError(
                "--study-name is required without --endpoint (the storage "
                "mirror is per-study)."
            )
        storage = _storage(args)
        study_id = storage.get_study_id_from_name(args.study_name)
        records = sorted(
            (
                value
                for key, value in storage.get_study_system_attrs(study_id).items()
                if key.startswith(autopilot.ACTION_ATTR_PREFIX)
                and isinstance(value, dict)
            ),
            key=lambda record: record.get("seq", 0),
        )
        if not records:
            # The storage mirror only holds act-mode decisions, so an empty
            # mirror is ambiguous — no findings fired, the loop ran in
            # observe mode, or no loop was armed. Say so instead of the
            # "not armed" hint, which would tell an operator with a healthy
            # act-mode study to re-enable something already running.
            message = (
                f"no autopilot actions recorded for study "
                f"{args.study_name!r} (no findings fired, the loop ran in "
                "observe mode, or no autopilot was armed — the storage "
                "mirror only holds act-mode decisions; use --endpoint for "
                "the live loop state)"
            )
            if args.format == "json":
                print(json.dumps(
                    {"enabled": None, "autopilots": [], "note": message},
                    sort_keys=True,
                ))
            else:
                print(message)
            return
        report = {
            "enabled": True,
            "generated_unix": None,
            "autopilots": [
                {
                    "study": args.study_name,
                    "mode": records[-1].get("mode"),
                    "actions": records,
                }
            ],
        }
    if args.format == "json":
        print(json.dumps(report, sort_keys=True))
    else:
        print(autopilot.render_text(report))


def _cmd_slo(args: argparse.Namespace) -> None:
    """The SLO engine's report (see :mod:`optuna_tpu_torch.slo`).

    Without ``--endpoint`` the report is this process's engine — disabled
    unless ``OPTUNA_TPU_TORCH_SLO`` was set or the invoked workflow armed it;
    with ``--endpoint`` it is fetched from a serving process's ``/slo.json``
    (``telemetry.serve_metrics``), which is where a live serving
    hub's quantiles and burn rates actually accumulate — byte-for-byte the
    same shape either way.
    """
    from optuna_tpu_torch import slo

    if args.endpoint:
        import urllib.request

        base = args.endpoint.rstrip("/")
        url = base if base.endswith("/slo.json") else base + "/slo.json"
        with urllib.request.urlopen(url, timeout=10) as response:
            report = json.loads(response.read().decode())
    else:
        report = slo.export_report()
    if args.format == "json":
        print(json.dumps(report, sort_keys=True))
    else:
        print(slo.render_text(report))


def _find_trajectory_file() -> str | None:
    """Walk up from the working directory looking for the committed
    ``BENCH_TRAJECTORY.json`` (the pyproject-discovery pattern): the CLI is
    usually run from somewhere inside the repo that owns the ledger."""
    cur = os.path.abspath(os.getcwd())
    while True:
        candidate = os.path.join(cur, "BENCH_TRAJECTORY.json")
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def _cmd_trajectory(args: argparse.Namespace) -> None:
    """Render the committed bench trajectory (``BENCH_TRAJECTORY.json``) —
    per-round ours-side value, steady-state trials/s, device stats,
    regressed/partial flags and git provenance — as a table or json,
    replacing the hand-rolled jq the r03->r04 claw-back hunt needed.

    Path resolution: ``--path``, then ``OPTUNA_TPU_BENCH_TRAJECTORY_PATH``
    (the same override ``bench.py`` honors), then the nearest
    ``BENCH_TRAJECTORY.json`` walking up from the working directory.
    """
    path = (
        args.path
        or os.environ.get("OPTUNA_TPU_BENCH_TRAJECTORY_PATH")
        or _find_trajectory_file()
    )
    if path is None or not os.path.isfile(path):
        raise CLIUsageError(
            "no BENCH_TRAJECTORY.json found (looked at --path, "
            "$OPTUNA_TPU_BENCH_TRAJECTORY_PATH, then upward from the "
            "working directory); pass --path explicitly."
        )
    with open(path, encoding="utf-8") as f:
        trajectory = json.load(f)
    entries = trajectory.get("entries", [])
    if args.metric:
        entries = [e for e in entries if e.get("metric") == args.metric]
    if args.format == "json":
        # Full fidelity (phases, compile, device_stats blocks included):
        # the jq-replacement surface.
        print(json.dumps({"path": path, "entries": entries}, sort_keys=True))
        return

    def _git(entry: dict[str, Any]) -> str:
        prov = entry.get("git") or {}
        sha = prov.get("sha", "")[:9]
        return sha + ("*" if prov.get("dirty") else "")

    def _device(entry: dict[str, Any]) -> str:
        stats = entry.get("device_stats") or {}
        mesh = entry.get("mesh") or {}
        serve = entry.get("serve") or {}
        ckpt = entry.get("ckpt") or {}
        if not stats and not mesh and not serve and not ckpt:
            return ""
        parts = []
        if ckpt:
            # Preemption-leg scan entries (bench --loop=scan --preempt-at=K)
            # lead with the checkpoint evidence: how many restores the run
            # paid and what the resumed incarnation spent in ckpt.restore.
            # Every field reads through .get so an entry written by a newer
            # bench with extra (or missing) ckpt keys still renders.
            parts.append(
                f"ckpt={ckpt.get('restores', 0)}"
                f"/{ckpt.get('resume_overhead_s', 0)}s"
            )
            if entry.get("preempt_at") is not None:
                parts.append(f"pre@{entry['preempt_at']}")
            if ckpt.get("fallbacks"):
                parts.append(f"fb={ckpt['fallbacks']}")
        if serve:
            # Serve-loop entries (bench --loop=serve) lead with the latency
            # contract: steady-state per-ask p99 vs the single-client twin's
            # mean ask latency (the bar it must meet), then ready-queue
            # hit/miss, widest observed coalesce, and any sheds. Fleet runs
            # (bench --loop=serve --hubs=N) carry the hub count beside them.
            parts.append(
                f"p99={serve.get('serve_ask_p99_ms')}ms"
                f"/1cl={serve.get('single_client_ask_ms')}ms"
            )
            if entry.get("transport") and entry["transport"] != "handler":
                # The comparability key's fourth axis: a socket capture is a
                # different figure and must be readable as one.
                parts.append(f"tr={entry['transport']}")
            if serve.get("hubs") is not None:
                parts.append(f"hubs={serve['hubs']}")
            parts.append(
                f"q={serve.get('ready_queue_hits', 0)}"
                f"/{serve.get('ready_queue_misses', 0)}"
            )
            if serve.get("coalesce_width_max") is not None:
                parts.append(f"w={serve['coalesce_width_max']}")
            if serve.get("sheds"):
                parts.append(f"shed={serve['sheds']}")
            if serve.get("sketch_p99_ms") is not None:
                # The SLO engine's P²-sketch tail beside the wall-clock one
                # (they should agree; drift means the sketch lies).
                parts.append(f"sk99={serve['sketch_p99_ms']}ms")
            if serve.get("slo"):
                parts.append(f"slo={serve['slo']}")
        if mesh:
            # Sharded-loop entries (bench --loop=sharded) lead with the mesh
            # geometry the number was captured on.
            parts.append(
                "mesh=" + "x".join(str(mesh[axis]) for axis in sorted(mesh, reverse=True))
            )
        if stats.get("max_ladder_rung") is not None:
            parts.append(f"rung={stats['max_ladder_rung']}")
        if stats.get("fit_iterations") is not None:
            parts.append(f"fit={stats['fit_iterations']}")
        if stats.get("quarantined") is not None:
            parts.append(f"quar={stats['quarantined']}")
        # Scan-loop entries (bench --loop=scan) additionally condense which
        # tell path ran: incremental row appends vs full refactorizations.
        if stats.get("scan_rank1_updates") is not None:
            parts.append(
                f"r1={stats['scan_rank1_updates']}/rf={stats.get('scan_refactorizations', 0)}"
            )
        # Large-n sparse-engine entries (bench --loop=scan --trials=N)
        # additionally condense the inducing regime: live inducing count and
        # the sparsity ratio the window settled at.
        if stats.get("inducing_count") is not None:
            parts.append(f"ind={stats['inducing_count']}")
            parts.append(f"sp={stats.get('sparsity_ratio', 0)}")
        return " ".join(parts)

    def _flags(entry: dict[str, Any]) -> str:
        flags = []
        if entry.get("regressed"):
            flags.append("REGRESSED")
        if entry.get("partial"):
            flags.append("partial")
        if entry.get("fallback"):
            flags.append("fallback")
        return ",".join(flags)

    rows = [
        {
            "round": e.get("round"),
            "captured": e.get("captured"),
            "metric": e.get("metric"),
            "mode": e.get("mode"),
            "platform": e.get("platform"),
            "value": e.get("value"),
            "steady_state": e.get("steady_state_trials_per_sec", ""),
            "device_stats": _device(e),
            "flags": _flags(e),
            "git": _git(e),
        }
        for e in entries
    ]
    print(_format_output(rows, "table"))


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="optuna-tpu-torch")
    parser.add_argument("--storage", default=None, help="DB/journal/grpc URL")
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name: str, fn, **extra):
        p = sub.add_parser(name)
        p.set_defaults(func=fn)
        # SUPPRESS so a subcommand-level --storage overrides but an absent one
        # does NOT clobber the top-level `optuna-tpu-torch --storage URL <cmd>` form.
        p.add_argument("--storage", default=argparse.SUPPRESS)
        return p

    p = add("create-study", _cmd_create_study)
    p.add_argument("--study-name", default=None)
    p.add_argument("--direction", default="minimize")
    p.add_argument("--directions", nargs="*", default=None)
    p.add_argument("--skip-if-exists", action="store_true")

    p = add("delete-study", _cmd_delete_study)
    p.add_argument("--study-name", required=True)

    p = add("studies", _cmd_studies)
    p.add_argument("-f", "--format", default="table", choices=["table", "json", "yaml"])

    p = add("study-names", _cmd_study_names)
    p.add_argument("-f", "--format", default="table", choices=["table", "json", "yaml"])

    p = add("trials", _cmd_trials)
    p.add_argument("--study-name", required=True)
    p.add_argument("-f", "--format", default="table", choices=["table", "json", "yaml"])

    p = add("best-trial", _cmd_best_trial)
    p.add_argument("--study-name", required=True)
    p.add_argument("-f", "--format", default="table", choices=["table", "json", "yaml"])

    p = add("best-trials", _cmd_best_trials)
    p.add_argument("--study-name", required=True)
    p.add_argument("-f", "--format", default="table", choices=["table", "json", "yaml"])

    p = add("study-set-user-attr", _cmd_study_set_user_attr)
    p.add_argument("--study-name", required=True)
    p.add_argument("--key", required=True)
    p.add_argument("--value", required=True)
    p.add_argument("--json-value", action="store_true")

    p = add("storage-upgrade", _cmd_storage_upgrade)

    p = add("ask", _cmd_ask)
    p.add_argument("--study-name", required=True)
    p.add_argument("--direction", default="minimize")
    p.add_argument("--directions", nargs="*", default=None)
    p.add_argument("--sampler", default=None)
    p.add_argument("--sampler-kwargs", default=None)
    p.add_argument("--search-space", default=None)

    p = add("metrics", _cmd_metrics)
    p.add_argument("-f", "--format", default="json", choices=["json", "prom"])
    p.add_argument(
        "--endpoint",
        default=None,
        help="fetch from a serving process (e.g. http://host:9090) instead of "
        "this process's registry",
    )

    p = add("trace", _cmd_trace)
    p.add_argument("-f", "--format", default="chrome", choices=["chrome", "events"])
    p.add_argument(
        "--trial",
        type=int,
        default=None,
        help="filter to one trial's events (plus their parent spans) for a "
        "single-trial postmortem instead of the whole ring",
    )
    p.add_argument(
        "--endpoint",
        default=None,
        help="fetch /trace.json from a serving process (e.g. http://host:9090) "
        "instead of this process's flight recorder",
    )
    p.add_argument(
        "-o", "--output", default=None, help="write to this file instead of stdout"
    )

    p = add("doctor", _cmd_doctor)
    p.add_argument("--study-name", required=True)
    p.add_argument("-f", "--format", default="text", choices=["text", "json"])
    p.add_argument(
        "--endpoint",
        default=None,
        help="fetch /health.json from a serving process (e.g. http://host:9090) "
        "instead of aggregating from --storage in this process; one endpoint "
        "is that hub's view, comma-separated endpoints merge a hub fleet's "
        "reports (unreachable hubs are listed, not fatal)",
    )

    p = add("autopilot", _cmd_autopilot)
    p.add_argument(
        "--study-name",
        default=None,
        help="study whose action log to show (required without --endpoint; "
        "filters the endpoint report otherwise)",
    )
    p.add_argument("-f", "--format", default="text", choices=["text", "json"])
    p.add_argument(
        "--endpoint",
        default=None,
        help="fetch /autopilot.json from a serving process (e.g. "
        "http://host:9090) instead of reading the audit mirror from --storage",
    )

    p = add("slo", _cmd_slo)
    p.add_argument("-f", "--format", default="text", choices=["text", "json"])
    p.add_argument(
        "--endpoint",
        default=None,
        help="fetch /slo.json from a serving process (e.g. http://host:9090) "
        "instead of this process's SLO engine",
    )

    p = add("trajectory", _cmd_trajectory)
    p.add_argument("-f", "--format", default="table", choices=["table", "json"])
    p.add_argument(
        "--path",
        default=None,
        help="trajectory file (default: $OPTUNA_TPU_BENCH_TRAJECTORY_PATH, "
        "then the nearest BENCH_TRAJECTORY.json walking up from the cwd)",
    )
    p.add_argument(
        "--metric", default=None, help="filter entries to one bench metric"
    )

    p = add("tell", _cmd_tell)
    p.add_argument("--study-name", required=True)
    p.add_argument("--trial-number", type=int, required=True)
    p.add_argument("--values", nargs="*", default=None)
    p.add_argument("--state", default=None)
    p.add_argument("--skip-if-finished", action="store_true")

    return parser


def main(argv: Sequence[str] | None = None) -> int:
    import optuna_tpu_torch

    optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
    parser = _build_parser()
    args = parser.parse_args(argv)
    try:
        args.func(args)
    except CLIUsageError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    except (KeyError, ValueError, OptunaTPUError) as e:
        message = e.args[0] if e.args else str(e)
        print(f"Error: {message}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
