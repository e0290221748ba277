"""The port's command line (``optuna_tpu_torch/cli.py``), artifacts
(``optuna_tpu_torch/artifacts/``) and integration shims against the
reference's, on the CPU.

Most commands run in-process through ``main(argv)`` (a fresh interpreter
imports torch in seconds); two runs go through ``python -m
optuna_tpu_torch.cli``, as a shell user would. Where both packages run a
command on one sqlite file, their outputs must be equal. ``ask`` passes
``--sampler-kwargs '{"device": "cpu"}'``: the default TPE samples on the
card, and raises on a machine without one.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu import cli as ref_cli
from optuna_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]
SPACE = json.dumps({"x": {"name": "FloatDistribution", "attributes": {"low": 0.0, "high": 1.0, "log": False,
                                                                     "step": None}}})
CPU_TPE = ["--sampler", "TPESampler", "--sampler-kwargs", json.dumps({"device": "cpu", "seed": 0})]


@pytest.fixture(autouse=True)
def _keep_verbosity():
    """``main`` lowers each package's logging to WARNING; put it back."""
    saved = optuna_tpu.logging.get_verbosity(), optuna_tpu_torch.logging.get_verbosity()
    yield
    optuna_tpu.logging.set_verbosity(saved[0])
    optuna_tpu_torch.logging.set_verbosity(saved[1])


def _run(main, capsys, *argv) -> tuple[int, str, str]:
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _module(*argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "optuna_tpu_torch.cli", *argv], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=180)


def test_cli_end_to_end(tmp_path, capsys):
    """The reference's ``tests/test_analysis.py::test_cli_end_to_end`` flow
    on the port, its first and last steps as ``python -m``."""
    url = f"sqlite:///{tmp_path}/cli.db"
    r = _module("create-study", "--storage", url, "--study-name", "cli-study")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "cli-study"

    rc, out, err = _run(cli.main, capsys, "ask", "--storage", url, "--study-name", "cli-study", "--search-space",
                        SPACE, *CPU_TPE)
    assert rc == 0, err
    asked = json.loads(out)
    assert "x" in asked["params"] and 0.0 <= asked["params"]["x"] <= 1.0

    rc, _, err = _run(cli.main, capsys, "tell", "--storage", url, "--study-name", "cli-study", "--trial-number",
                      str(asked["number"]), "--values", "0.5")
    assert rc == 0, err
    rc, out, _ = _run(cli.main, capsys, "trials", "--storage", url, "--study-name", "cli-study", "-f", "json")
    rows = json.loads(out)
    assert rc == 0 and len(rows) == 1 and rows[0]["state"] == "COMPLETE" and rows[0]["values"] == [0.5]
    rc, out, _ = _run(cli.main, capsys, "best-trial", "--storage", url, "--study-name", "cli-study", "-f", "json")
    assert rc == 0 and json.loads(out)[0]["number"] == asked["number"]
    rc, out, _ = _run(cli.main, capsys, "studies", "--storage", url, "-f", "table")
    assert rc == 0 and "cli-study" in out
    rc, _, err = _run(cli.main, capsys, "delete-study", "--storage", url, "--study-name", "cli-study")
    assert rc == 0, err
    r = _module("studies", "--storage", url, "-f", "json")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout) == []


def test_a_study_written_by_the_reference_reads_the_same(tmp_path, capsys):
    """A sqlite study written through ``optuna_tpu.cli`` (two asks and
    tells, a user attr, a second study with two objectives) reads the same
    through both CLIs in every format."""
    url = f"sqlite:///{tmp_path}/ref.db"
    assert ref_cli.main(["create-study", "--storage", url, "--study-name", "s"]) == 0
    assert ref_cli.main(["create-study", "--storage", url, "--study-name", "mo", "--directions", "minimize",
                         "maximize"]) == 0
    for i, value in enumerate((0.25, 0.75)):
        assert ref_cli.main(["ask", "--storage", url, "--study-name", "s", "--search-space", SPACE,
                             "--sampler", "RandomSampler", "--sampler-kwargs", '{"seed": 0}']) == 0
        assert ref_cli.main(["tell", "--storage", url, "--study-name", "s", "--trial-number", str(i),
                             "--values", str(value)]) == 0
        assert ref_cli.main(["ask", "--storage", url, "--study-name", "mo", "--search-space", SPACE,
                             "--sampler", "RandomSampler"]) == 0
        assert ref_cli.main(["tell", "--storage", url, "--study-name", "mo", "--trial-number", str(i),
                             "--values", str(value), str(1 - value)]) == 0
    assert ref_cli.main(["study-set-user-attr", "--storage", url, "--study-name", "s", "--key", "k",
                         "--value", '{"a": [1, 2]}', "--json-value"]) == 0
    capsys.readouterr()
    commands = [["studies"], ["study-names"]] + [
        [cmd, "--study-name", name] for cmd in ("trials", "best-trial", "best-trials") for name in ("s", "mo")
        if not (cmd == "best-trial" and name == "mo")
    ]
    for command in commands:
        for fmt in ("json", "table", "yaml"):
            argv = [command[0], "--storage", url, *command[1:], "-f", fmt]
            ref = _run(ref_cli.main, capsys, *argv)
            port = _run(cli.main, capsys, *argv)
            assert port == ref and port[0] == 0, argv
    study = optuna_tpu_torch.load_study(study_name="s", storage=url)
    assert study.user_attrs == {"k": {"a": [1, 2]}}
    assert [t.value for t in study.trials] == [0.25, 0.75]
    for main in (ref_cli.main, cli.main):  # a multi-objective study has no single best trial in either
        with pytest.raises(RuntimeError, match="multi-objective"):
            main(["best-trial", "--storage", url, "--study-name", "mo"])


def test_storage_upgrade_walks_a_v1_file_as_the_reference(tmp_path, capsys):
    fixture = REPO / "tests" / "fixtures" / "rdb_v1.db"
    outs = []
    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        db = tmp_path / f"{name}.db"
        shutil.copy(fixture, db)
        first = _run(main, capsys, "storage-upgrade", "--storage", f"sqlite:///{db}")
        again = _run(main, capsys, "storage-upgrade", "--storage", f"sqlite:///{db}")
        outs.append((first, again))
    assert outs[1] == outs[0]
    (first, again) = outs[1]
    assert first[0] == 0 and "Upgraded storage schema" in first[1]
    assert again[0] == 0 and "up to date" in again[1]


def test_trajectory_renders_the_ledger_as_the_reference(capsys):
    path = str(REPO / "BENCH_TRAJECTORY.json")
    for argv in (["trajectory", "--path", path], ["trajectory", "--path", path, "-f", "json"],
                 ["trajectory", "--path", path, "--metric", "gp_scan_trials_per_sec_hartmann20d_end_to_end"]):
        ref = _run(ref_cli.main, capsys, *argv)
        port = _run(cli.main, capsys, *argv)
        assert port == ref and port[0] == 0, argv
    rc, _, err = _run(cli.main, capsys, "trajectory", "--path", "/nonexistent/BENCH_TRAJECTORY.json")
    assert rc == 2 and "no BENCH_TRAJECTORY.json" in err


class _Clock:
    def __init__(self) -> None:
        self.t = 50.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def observability_state():
    """Both packages' telemetry, flight, SLO and health state, scripted the
    same way on injected clocks, and restored afterwards."""
    from optuna_tpu import flight as rf, slo as rs, telemetry as rt
    from optuna_tpu_torch import flight as pf, slo as ps, telemetry as pt

    pairs = ((rt, rf, rs), (pt, pf, ps))
    saved = [(t.get_registry(), t.enabled(), f.get_recorder(), f.enabled(), s.enabled(), s.get_engine())
             for t, f, s in pairs]
    for t, f, s in pairs:
        clock = _Clock()
        t.enable(t.MetricsRegistry(clock=clock))
        f.enable(f.FlightRecorder(capacity=256, clock=clock, epoch=1000.0, trace_id="0123456789abcdef"))
        s.enable(clock=clock)
        f.reset_jit_totals()
        for i in range(6):
            with f.span("ask"), t.span("ask"):
                clock.t += 0.002 * (i + 1)
            f.trial_event("ask", i)
            with f.span("dispatch", i), t.span("dispatch"):
                clock.t += 0.25
            t.count("sampler.fallback.relative" if i % 2 else "storage.retry")
            with f.span("tell", i), t.span("tell"):
                clock.t += 0.01
            f.trial_event("tell", i, "COMPLETE")
            clock.t += 7.0
        t.set_gauge("device.gp.sparse_heldout_err.last", 0.625)
        f._note_jit_compile("gp.suggest_fused", 1.5, False)
    yield
    for (t, f, s), (registry, t_on, recorder, f_on, s_on, engine) in zip(pairs, saved):
        t.enable(registry)
        if not t_on:
            t.disable()
        f.enable(recorder)
        if not f_on:
            f.disable()
        f.reset_jit_totals()
        s.disable()
        s._ENGINE = engine
        if s_on:
            s.enable()


def _doctor_storage(tmp_path) -> str:
    """A sqlite study written by the port: trials, a live worker's and a dead
    worker's health snapshots, and an act-mode autopilot decision with its
    rollback mirrored."""
    from optuna_tpu_torch import autopilot, health, telemetry
    from optuna_tpu_torch.testing.fault_injection import plant_dead_worker

    url = f"sqlite:///{tmp_path}/doctor.db"
    study = optuna_tpu_torch.create_study(storage=url, study_name="s",
                                          sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    settings = {k: getattr(health, k) for k in ("_interval_s", "_worker_id", "_clock", "_now")}
    telemetry.enable(telemetry.MetricsRegistry())
    health.enable(interval_s=0.0, worker_id="w-live")
    try:
        study.optimize(lambda t: 1.0 + t.suggest_float("x", 0, 1), n_trials=4)
        study.optimize(lambda t: 2.0 + t.suggest_float("x", 0, 1), n_trials=20)
    finally:
        health.disable()
        for key, value in settings.items():  # enable's settings outlive disable
            setattr(health, key, value)
    plant_dead_worker(study, worker_id="w-dead", age_s=3600.0)
    pilot = autopilot.Autopilot(study, autopilot.AutopilotPolicy(
        mode="act", rollback_after=1, cooldown_s=3600.0, clock=lambda: 0.0, now=lambda: 1_700_000_000.0))
    study._scan_gp_control = {"n_exact_max": 12, "n_inducing": 64}
    telemetry.set_gauge("device.gp.sparse_heldout_err.last", 1.5)
    pilot.step()  # decides gp.densify (and stagnation, which has no target here)
    study.optimize(lambda t: 3.0, n_trials=1)
    pilot.step()  # the error did not fall: rolled back
    telemetry.disable()
    return url


def _masked(text: str, command: str) -> str:
    """What may differ between two processes' runs of one command: the
    report stamp, the snapshot ages, the process name of a trace, and the
    package's own names in hints."""
    text = text.replace("OPTUNA_TPU_TORCH_", "OPTUNA_TPU_").replace("optuna-tpu-torch", "optuna-tpu")
    text = re.sub(r'"generated_unix": [0-9.e+]+', '"generated_unix": 0', text)
    text = re.sub(r'"age_s": [0-9.e+]+', '"age_s": 0', text)
    text = re.sub(r"last seen [0-9.]+s ago", "last seen Ns ago", text)
    text = re.sub(r"""(["'])w-dead\1: [0-9.]+""", r"\1w-dead\1: N", text)  # a dead worker's age as evidence
    text = re.sub(r'"name": "optuna-tpu\[[0-9a-f]+\]"', '"name": "<process>"', text)
    return re.sub(r'"pid": [0-9]+', '"pid": 0', text)


OBSERVABILITY_CASES = {
    "metrics json": ["metrics", "-f", "json"],
    "metrics prom": ["metrics", "-f", "prom"],
    "trace chrome": ["trace"],
    "trace events of one trial": ["trace", "-f", "events", "--trial", "2"],
    "doctor json": ["doctor", "--study-name", "s", "-f", "json"],
    "doctor text": ["doctor", "--study-name", "s"],
    "autopilot json": ["autopilot", "--study-name", "s", "-f", "json"],
    "autopilot text": ["autopilot", "--study-name", "s"],
    "slo json": ["slo", "-f", "json"],
    "slo text": ["slo"],
}


@pytest.mark.parametrize("case", sorted(OBSERVABILITY_CASES))
def test_observability_commands_match_the_reference(case, tmp_path, capsys, observability_state):
    """Each of ``metrics``, ``trace``, ``doctor``, ``autopilot`` and ``slo``,
    in json and text, prints what the reference's prints: on one sqlite file
    for the storage commands, on the same scripted telemetry, flight and SLO
    state for the process-local ones."""
    argv = list(OBSERVABILITY_CASES[case])
    if argv[0] in ("doctor", "autopilot"):
        argv = ["--storage", _doctor_storage(tmp_path)] + argv
    ref = _run(ref_cli.main, capsys, *argv)
    port = _run(cli.main, capsys, *argv)
    assert port[0] == ref[0] == 0, port[2]
    assert _masked(port[1], argv[0]) == _masked(ref[1], argv[0])
    assert port[1].strip()
    if case == "doctor json":
        checks = {f["check"] for f in json.loads(port[1])["findings"]}
        assert {"worker.dead", "study.stagnation"} <= checks
    if case == "autopilot json":
        (loop,) = json.loads(port[1])["autopilots"]
        assert [(r["action"], r["state"]) for r in loop["actions"] if r["action"] == "gp.densify"] == [
            ("gp.densify", "rolled_back")
        ]
    assert cli.NOT_YET_PORTED == {}


def test_the_trace_command_writes_a_file_and_the_endpoint_flags_hold(tmp_path, capsys, observability_state):
    out = tmp_path / "trace.json"
    rc, printed, _ = _run(cli.main, capsys, "trace", "-o", str(out))
    assert rc == 0 and printed.strip() == str(out)
    assert json.loads(out.read_text())["otherData"]["trace_id"] == "0123456789abcdef"
    rc, _, err = _run(cli.main, capsys, "trace", "--endpoint", "http://127.0.0.1:1", "-f", "events")
    assert rc == 2 and "Chrome trace JSON only" in err
    rc, _, err = _run(cli.main, capsys, "metrics", "--endpoint", "http://127.0.0.1:1/metrics", "-f", "json")
    assert rc == 2 and "pass the matching --format" in err
    rc, _, err = _run(cli.main, capsys, "autopilot")
    assert rc == 2 and "--study-name is required" in err


def test_usage_errors_match_the_reference(capsys):
    for argv in (["studies"], ["ask", "--study-name", "s", "--storage", "sqlite:///:memory:", "--sampler", "Nope"]):
        ref = _run(ref_cli.main, capsys, *argv)
        port = _run(cli.main, capsys, *argv)
        assert port == ref and port[0] == 2, argv
    with pytest.raises(SystemExit):
        cli.main(["no-such-command"])
    assert cli._build_parser().prog == "optuna-tpu-torch"


def test_ask_with_the_default_sampler_runs_on_the_card(tmp_path, capsys):
    url = f"sqlite:///{tmp_path}/card.db"
    argv = ["ask", "--storage", url, "--study-name", "s", "--search-space", SPACE]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            cli.main(argv)


def test_the_console_script_is_declared():
    import tomllib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["optuna-tpu-torch"] == "optuna_tpu_torch.cli:main"
    assert scripts["optuna-tpu"] == "optuna_tpu.cli:main"


# ------------------------------------------------------------------ artifacts


def _artifact_study(mod, storage, store, src):
    study = mod.create_study(storage=storage, study_name="art", sampler=mod.samplers.RandomSampler(seed=0),
                             load_if_exists=True)
    ids = {}

    def objective(trial):
        ids["trial"] = mod.artifacts.upload_artifact(artifact_store=store, file_path=str(src), study_or_trial=trial)
        return trial.suggest_float("x", 0, 1)

    study.optimize(objective, n_trials=1)
    ids["study"] = mod.artifacts.upload_artifact(artifact_store=store, file_path=str(src), study_or_trial=study,
                                                 mimetype="text/x-custom")
    return study, ids


def test_artifact_round_trip(tmp_path):
    from optuna_tpu_torch.artifacts import Backoff, FileSystemArtifactStore, download_artifact, get_all_artifact_meta

    store = Backoff(FileSystemArtifactStore(str(tmp_path / "store")))
    src = tmp_path / "model.txt"
    src.write_text("weights")
    study, ids = _artifact_study(optuna_tpu_torch, None, store, src)
    (meta,) = get_all_artifact_meta(study.trials[0])
    assert (meta.artifact_id, meta.filename, meta.mimetype) == (ids["trial"], "model.txt", "text/plain")
    (study_meta,) = get_all_artifact_meta(study)
    assert study_meta.mimetype == "text/x-custom"
    dst = tmp_path / "restored.txt"
    download_artifact(artifact_store=store, artifact_id=ids["trial"], file_path=str(dst))
    assert dst.read_text() == "weights"
    frozen = study.trials[0]
    with pytest.raises(ValueError, match="storage is required"):
        optuna_tpu_torch.artifacts.upload_artifact(artifact_store=store, file_path=str(src), study_or_trial=frozen)
    with pytest.raises(TypeError):
        optuna_tpu_torch.artifacts.upload_artifact(artifact_store=store, file_path=str(src), study_or_trial=object())
    store.remove(ids["trial"])
    with pytest.raises(optuna_tpu_torch.artifacts.ArtifactNotFound):
        store.open_reader(ids["trial"])
    with pytest.raises(ValueError, match="Invalid artifact_id"):
        FileSystemArtifactStore(str(tmp_path)).open_reader("a/b")


def test_an_artifact_uploaded_through_the_reference_downloads_through_the_port(tmp_path):
    url = f"sqlite:///{tmp_path}/art.db"
    src = tmp_path / "weights.json"
    src.write_text('{"w": [1, 2, 3]}')
    store_dir = str(tmp_path / "store")
    _, ids = _artifact_study(optuna_tpu, url, optuna_tpu.artifacts.FileSystemArtifactStore(store_dir), src)
    study = optuna_tpu_torch.load_study(study_name="art", storage=url)
    store = optuna_tpu_torch.artifacts.FileSystemArtifactStore(store_dir)
    (meta,) = optuna_tpu_torch.artifacts.get_all_artifact_meta(study.trials[0])
    ref_meta = optuna_tpu.artifacts.get_all_artifact_meta(optuna_tpu.load_study(study_name="art", storage=url).trials[0])
    assert vars(meta) == vars(ref_meta[0])
    assert (meta.artifact_id, meta.filename, meta.mimetype) == (ids["trial"], "weights.json", "application/json")
    dst = tmp_path / "out.json"
    optuna_tpu_torch.artifacts.download_artifact(artifact_store=store, artifact_id=meta.artifact_id,
                                                 file_path=str(dst))
    assert dst.read_text() == src.read_text()
    (study_meta,) = optuna_tpu_torch.artifacts.get_all_artifact_meta(study)
    assert study_meta.artifact_id == ids["study"]


def test_backoff_retries_transient_errors_and_not_a_missing_artifact(tmp_path, monkeypatch):
    import io

    from optuna_tpu_torch.artifacts import ArtifactNotFound, Backoff

    monkeypatch.setattr("time.sleep", lambda s: None)
    calls = []

    class Flaky:
        def write(self, artifact_id, body):
            calls.append(body.read())
            if len(calls) < 3:
                raise OSError("transient")

        def open_reader(self, artifact_id):
            calls.append("read")
            raise ArtifactNotFound(artifact_id)

        def remove(self, artifact_id):
            raise OSError("always")

    store = Backoff(Flaky(), max_retries=3, min_delay=0.0)
    store.write("a", io.BytesIO(b"abc"))
    assert calls == [b"abc"] * 3  # each retry re-reads the body from its start
    calls.clear()
    with pytest.raises(ArtifactNotFound):
        store.open_reader("a")
    assert calls == ["read"]
    with pytest.raises(OSError):
        store.remove("a")


def test_the_cloud_stores_are_gated_on_their_packages():
    import importlib.util

    if importlib.util.find_spec("boto3") is None:
        with pytest.raises(ImportError, match="boto3"):
            optuna_tpu_torch.artifacts.Boto3ArtifactStore("bucket")
    try:
        from google.cloud import storage  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="google-cloud-storage"):
            optuna_tpu_torch.artifacts.GCSArtifactStore("bucket")


def test_artifacts_and_integration_surfaces_match_the_reference():
    assert optuna_tpu_torch.artifacts.__all__ == optuna_tpu.artifacts.__all__
    from optuna_tpu_torch.artifacts.exceptions import ArtifactNotFound

    assert ArtifactNotFound is optuna_tpu_torch.artifacts.ArtifactNotFound
    assert issubclass(ArtifactNotFound, optuna_tpu_torch.exceptions.OptunaTPUError)
    assert optuna_tpu_torch.integration.__all__ == optuna_tpu.integration.__all__
    for name in optuna_tpu_torch.integration.__all__:
        with pytest.raises(ImportError, match=f"optuna_tpu_torch.integration.{name} requires"):
            getattr(optuna_tpu_torch.integration, name)
    with pytest.raises(AttributeError):
        optuna_tpu_torch.integration.NoSuchIntegration  # noqa: B018
    assert issubclass(optuna_tpu_torch.exceptions.CLIUsageError, optuna_tpu_torch.exceptions.OptunaTPUError)
