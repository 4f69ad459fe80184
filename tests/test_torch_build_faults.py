"""
The build's fault ladder and its reports, and the CLI's argument checks,
against the JAX package's on the CPU:

- one fault plan (``GORDO_TPU_FAULT_PLAN``: a transient fetch fault, a
  permanent one, poisoned data, a divergence and a transient bucket fault)
  runs the JAX fleet trainer (``gordo-tpu batch-build`` under click's
  ``CliRunner``) and the port's (``python -m gordo_tpu_torch batch-build
  --device cpu`` in this process) over the same configs: the same exit code,
  the same quarantine lines on stderr (``attempts=`` included), the same
  ``--quarantine-report-file`` (but the observing host), the same deltas of
  ``gordo_build_fault_retries_total`` and ``gordo_build_bucket_retries_total``;
- the serial builders retry a transient fetch, record it in
  ``fault_domain`` and refuse poisoned data alike;
- the exceptions reporter: the same exception gives the same exit code and
  the same JSON at each level, trimmed alike; a failing ``build`` writes the
  same report through both CLIs;
- ``run-server`` and ``run-gateway`` exit 2 on the same argument lists with
  the same reason (the repair of ROADMAP C1).
Exact throughout: records, codes and counters are integers and strings.
"""

import json
import sys

import pytest
from click.testing import CliRunner

from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.cli import exceptions_reporter as jax_reporter
from gordo_tpu.cli.cli import _exceptions_reporter as jax_cli_reporter
from gordo_tpu.cli.cli import gordo
from gordo_tpu.dataset.datasets import InsufficientDataError as JaxInsufficientDataError
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.observability import metrics as jax_catalog
from gordo_tpu.util import faults as jax_faults
from gordo_tpu_torch import cli, cli_exceptions_reporter as reporter
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.builder.build_model import NonFiniteDataError
from gordo_tpu_torch.dataset.datasets import InsufficientDataError
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.observability import metrics as catalog
from gordo_tpu_torch.util import faults

PLAN = {"rules": [
    {"site": "data_fetch", "machine": "m-0", "error": "transient", "times": 1},
    {"site": "data_fetch", "machine": "m-1", "error": "permanent", "times": -1},
    {"site": "poison_nan", "machine": "m-2"},
    {"site": "diverge", "machine": "m-3"},
    {"site": "bucket_compile", "error": "transient", "times": 1},
]}


def _machine(name: str) -> dict:
    return {
        "name": name,
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-01-02T00:00:00+00:00",
                    "tags": ["a", "b", "c", "d"]},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.models.AutoEncoder": {
                    "kind": "feedforward_hourglass", "epochs": 1}}]}}}},
        "evaluation": {"cv_mode": "full_build", "seed": 0},
    }


@pytest.fixture
def plan(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_FAULT_PLAN", json.dumps(PLAN))
    monkeypatch.setenv("GORDO_TPU_FAULT_BACKOFF_BASE", "0")
    for module in (faults, jax_faults):
        module.reset_plan()
    yield
    for module in (faults, jax_faults):
        module.reset_plan()


def _retries(metrics_module) -> tuple:
    return (metrics_module.FAULT_RETRIES.value(operation="data_fetch"),
            metrics_module.BUCKET_RETRIES.value())


def _quarantine_lines(text: str) -> list:
    return [line for line in text.splitlines() if line.startswith("quarantined: ")]


def test_one_fault_plan_gives_both_fleets_the_same_outcome(tmp_path, plan, capsys):
    config = tmp_path / "fleet.json"
    config.write_text(json.dumps({"machines": [_machine(f"m-{m}") for m in range(5)]}))

    before = _retries(catalog)
    code = cli.main(["batch-build", str(config), str(tmp_path / "port"), "--device", "cpu",
                     "--quarantine-report-file", str(tmp_path / "port.json")])
    port_retries = [a - b for a, b in zip(_retries(catalog), before)]
    port_lines = _quarantine_lines(capsys.readouterr().err)

    before = _retries(jax_catalog)
    result = CliRunner().invoke(gordo, [
        "batch-build", str(config), "--output-dir", str(tmp_path / "jax"),
        "--quarantine-report-file", str(tmp_path / "jax.json")])
    jax_retries = [a - b for a, b in zip(_retries(jax_catalog), before)]

    assert code == result.exit_code == faults.EXIT_PARTIAL, result.output
    assert port_lines == _quarantine_lines(result.stderr) and len(port_lines) == 3
    ours, theirs = (json.loads((tmp_path / f"{side}.json").read_text())
                    for side in ("port", "jax"))
    for report in (ours, theirs):
        for record in report["quarantined"]:
            record.pop("host")
    assert ours == theirs
    assert [(r["machine"], r["stage"], r["reason"], r["attempts"])
            for r in ours["quarantined"]] == [
        ("m-1", "data_fetch", "permanent_fetch_failure", 1),
        ("m-2", "data_validation", "non_finite_data", 1),
        ("m-3", "training", "diverged", 1)]
    assert ours["built"] == 2
    assert port_retries == jax_retries == [1, 1]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["m-0", "m-4"]


def test_an_exhausted_transient_fetch_is_quarantined_alike(tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_FAULT_PLAN", json.dumps({"rules": [
        {"site": "data_fetch", "machine": "m-0", "error": "transient", "times": -1}]}))
    monkeypatch.setenv("GORDO_TPU_FAULT_BACKOFF_BASE", "0")
    monkeypatch.setenv("GORDO_TPU_FAULT_MAX_ATTEMPTS", "2")
    from gordo_tpu.parallel.batch_trainer import BatchedModelBuilder as JaxBatched
    from gordo_tpu_torch.parallel.batch_trainer import BatchedModelBuilder

    faults.reset_plan()
    ours = BatchedModelBuilder([Machine.from_config(_machine("m-0"), "p")], device="cpu")
    ours.build()
    jax_faults.reset_plan()
    theirs = JaxBatched([JaxMachine.from_config(_machine("m-0"), "p")])
    theirs.build()
    (record,), (jax_record,) = ours.quarantine_records, theirs.quarantine_records
    assert (record.stage, record.reason, record.attempts, record.error) == (
        jax_record.stage, jax_record.reason, jax_record.attempts, jax_record.error)
    assert record.reason == "transient_fetch_failure" and record.attempts == 2
    faults.reset_plan()
    jax_faults.reset_plan()


def test_serial_builders_retry_a_transient_fetch_and_refuse_poison_alike(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_FAULT_BACKOFF_BASE", "0")
    monkeypatch.setenv("GORDO_TPU_FAULT_PLAN", json.dumps({"rules": [
        {"site": "data_fetch", "machine": "m-0", "error": "transient", "times": 1}]}))
    for module in (faults, jax_faults):
        module.reset_plan()
    before = (catalog.FAULT_RETRIES.value(operation="data_fetch"),
              jax_catalog.FAULT_RETRIES.value(operation="data_fetch"))
    _, built = ModelBuilder(Machine.from_config(_machine("m-0"), "p"), device="cpu").build()
    _, jax_built = JaxModelBuilder(JaxMachine.from_config(_machine("m-0"), "p")).build()
    assert (built.metadata.build_metadata.fault_domain
            == jax_built.metadata.build_metadata.fault_domain
            == {"quarantined": False, "data_fetch_attempts": 2})
    assert (catalog.FAULT_RETRIES.value(operation="data_fetch") - before[0]
            == jax_catalog.FAULT_RETRIES.value(operation="data_fetch") - before[1] == 1)
    monkeypatch.setenv("GORDO_TPU_FAULT_PLAN", json.dumps({"rules": [
        {"site": "poison_nan", "machine": "m-0"}]}))
    with pytest.raises(NonFiniteDataError, match="non-finite values in X"):
        ModelBuilder(Machine.from_config(_machine("m-0"), "p"), device="cpu").build()
    with pytest.raises(jax_faults.NonFiniteDataError, match="non-finite values in X"):
        JaxModelBuilder(JaxMachine.from_config(_machine("m-0"), "p")).build()
    for module in (faults, jax_faults):
        module.reset_plan()


def _raised(exc):
    try:
        raise exc
    except Exception:  # noqa: BLE001 -- the exception under report
        return sys.exc_info()


@pytest.mark.parametrize("level", reporter.ReportLevel.get_names())
@pytest.mark.parametrize("make", [
    lambda pkg: FileNotFoundError("no such file: é"),
    lambda pkg: PermissionError("denied"),
    lambda pkg: (InsufficientDataError if pkg == "port" else JaxInsufficientDataError)(
        "Only 3 rows " + "x" * 3000),
    lambda pkg: RuntimeError("boom"),
])
def test_exceptions_reporter_matches_jax(tmp_path, level, make):
    for limit in (None, 1524):
        docs = {}
        for pkg, module, table in (("port", reporter, cli._exceptions_reporter),
                                   ("jax", jax_reporter, jax_cli_reporter)):
            exc_type, exc, tb = _raised(make(pkg))
            path = tmp_path / f"{pkg}.json"
            table.safe_report(module.ReportLevel.get_by_name(level), exc_type, exc, tb,
                              str(path), max_message_len=limit)
            docs[pkg] = json.loads(path.read_text())
            docs[pkg + "_code"] = table.exception_exit_code(exc_type)
            if "traceback" in docs[pkg]:  # the frames differ only by the line raising
                docs[pkg]["traceback"] = len(docs[pkg]["traceback"])
        assert docs["port"] == docs["jax"] and docs["port_code"] == docs["jax_code"]
        if limit:
            assert len(json.dumps(docs["port"])) <= limit


def test_a_failing_build_reports_alike_through_both_clis(tmp_path):
    config = _machine("m-short")
    config["dataset"]["n_samples_threshold"] = 10_000
    port_report, jax_report = tmp_path / "port.json", tmp_path / "jax.json"
    code = cli.main(["build", json.dumps(config), str(tmp_path / "port"), "--device", "cpu",
                     "--exceptions-reporter-file", str(port_report),
                     "--exceptions-report-level", "message"])
    result = CliRunner().invoke(gordo, [
        "build", json.dumps(config), str(tmp_path / "jax"),
        "--exceptions-reporter-file", str(jax_report), "--exceptions-report-level", "MESSAGE"])
    assert code == result.exit_code == 80
    assert json.loads(port_report.read_text()) == json.loads(jax_report.read_text()) == {
        "type": "InsufficientDataError",
        "message": "Only 144 rows after joining/filtering; threshold is 10000",
        "exit_code": 80}


@pytest.mark.parametrize("command, argv, reason", [
    ("run-server", ["--host", "not-an-ip"], "'not-an-ip' is not a valid IP address"),
    ("run-server", ["--host", "localhost"], "'localhost' is not a valid IP address"),
    ("run-server", ["--port", "70000"], "70000 is not in the range 1<=x<=65535."),
    ("run-server", ["--port", "0"], "0 is not in the range 1<=x<=65535."),
    ("run-server", ["--port", "x"], "'x' is not a valid integer range."),
    ("run-server", ["--workers", "9"], "9 is not in the range 1<=x<=4."),
    ("run-gateway", ["--host", "localhost"], "'localhost' is not a valid IP address"),
    ("run-gateway", ["--host", "1.2.3"], "'1.2.3' is not a valid IP address"),
    ("run-gateway", ["--port", "70000"], "70000 is not in the range 1<=x<=65535."),
])
def test_host_and_port_checks_exit_2_as_in_jax(command, argv, reason, capsys):
    result = CliRunner().invoke(gordo, [command, *argv])
    assert result.exit_code == 2 and reason in result.output, result.output
    with pytest.raises(SystemExit) as exited:
        cli.main([command, *argv])
    assert exited.value.code == 2
    assert reason in capsys.readouterr().err


@pytest.mark.parametrize("variable, value, reason", [
    ("GORDO_SERVER_HOST", "not-an-ip", "'not-an-ip' is not a valid IP address"),
    ("GORDO_SERVER_PORT", "70000", "70000 is not in the range 1<=x<=65535."),
])
def test_environment_values_are_checked_as_in_jax(monkeypatch, variable, value, reason, capsys):
    monkeypatch.setenv(variable, value)
    result = CliRunner().invoke(gordo, ["run-server"])
    assert result.exit_code == 2 and reason in result.output, result.output
    with pytest.raises(SystemExit) as exited:
        cli.main(["run-server"])
    assert exited.value.code == 2 and reason in capsys.readouterr().err


def test_valid_hosts_and_ports_parse():
    args = cli._parser().parse_args(["run-server", "--host", "::1", "--port", "65535"])
    assert (args.host, args.port) == ("::1", 65535)
    args = cli._parser().parse_args(["run-gateway", "--host", "127.0.0.1", "--port", "1"])
    assert (args.host, args.port) == ("127.0.0.1", 1)
