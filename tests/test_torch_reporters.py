"""
The reporters (``gordo_tpu_torch/reporters/``) against the JAX package's
(``gordo_tpu/reporters/``): one stub ``psycopg2`` and one stub ``mlflow``
(the external services; neither library is installed) serve both
packages' reporters on the same machine, and the rows and batches they
record are held equal. Also: the same exception class where the library
is missing, exit 90 with the same JSON report through both CLIs, and the
JAX paths written back by ``to_dict``.
"""

import json
import logging
import sqlite3
import sys
import time
import types

import pytest
import yaml
from click.testing import CliRunner

from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.cli.cli import _exceptions_reporter as jax_exit_codes, gordo
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.reporters import mlflow as jax_mlflow, postgres as jax_postgres
from gordo_tpu.reporters.base import BaseReporter as JaxBaseReporter
from gordo_tpu_torch import cli, serializer
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.reporters import mlflow, postgres
from gordo_tpu_torch.reporters.base import BaseReporter, ReporterException

CONFIG = {
    "name": "report-machine",
    "dataset": {"type": "RandomDataset", "tags": ["tag-1", "tag-2"],
                "train_start_date": "2019-01-01T00:00:00+00:00",
                "train_end_date": "2019-01-02T00:00:00+00:00"},
    "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.models.models.AutoEncoder": {
            "kind": "feedforward_hourglass", "epochs": 2}}}},
}
POSTGRES = {"gordo_tpu.reporters.postgres.PostgresReporter": {"host": "127.0.0.1"}}
MLFLOW = {"gordo_tpu.reporters.mlflow.MlFlowReporter": {"tracking_uri": "file:///mlruns",
                                                        "experiment_name": "smoke"}}


class Service:
    """What the stubs recorded: SQL statements with their parameters, and
    MLflow calls."""

    def __init__(self):
        self.sql, self.mlflow = [], []


def _stub_modules(service: Service) -> dict:
    class Cursor:
        def execute(self, sql, params=None):
            service.sql.append((" ".join(sql.split()), params))

    class Connection:
        def cursor(self):
            return Cursor()

        def commit(self):
            service.sql.append(("COMMIT", None))

        def close(self):
            pass

    psycopg2 = types.ModuleType("psycopg2")
    psycopg2.connect = lambda **kwargs: service.sql.append(("CONNECT", kwargs)) or Connection()

    class Record(dict):
        def __init__(self, **kwargs):
            super().__init__(kwargs)

    class Client:
        def __init__(self, tracking_uri=None):
            service.mlflow.append(("client", tracking_uri))

        def get_experiment_by_name(self, name):
            service.mlflow.append(("get_experiment", name))

        def create_experiment(self, name):
            service.mlflow.append(("create_experiment", name))
            return "experiment-1"

        def create_run(self, experiment_id, run_name=None):
            service.mlflow.append(("create_run", experiment_id, run_name))
            return types.SimpleNamespace(info=types.SimpleNamespace(run_id="run-1"))

        def log_batch(self, run_id, metrics, params):
            service.mlflow.append(("log_batch", run_id, [dict(m) for m in metrics],
                                   [dict(p) for p in params]))

        def log_artifact(self, run_id, path):
            with open(path) as fh:
                service.mlflow.append(("log_artifact", run_id, json.load(fh)))

        def set_terminated(self, run_id, status="FINISHED"):
            service.mlflow.append(("set_terminated", run_id, status))

    entities = types.ModuleType("mlflow.entities")
    entities.Metric = entities.Param = Record
    tracking = types.ModuleType("mlflow.tracking")
    tracking.MlflowClient = Client
    package = types.ModuleType("mlflow")
    package.entities, package.tracking = entities, tracking
    return {"psycopg2": psycopg2, "mlflow": package, "mlflow.entities": entities,
            "mlflow.tracking": tracking}


@pytest.fixture(scope="module")
def built_machine_dict():
    """A machine as the JAX builder leaves it (CV scores, fit history,
    durations), as a dict both packages' Machine.from_dict read."""
    machine = JaxMachine.from_config(CONFIG, project_name="reporters")
    _, built = JaxModelBuilder(machine).build()
    return json.loads(json.dumps(built.to_dict(), default=str))


def _record(monkeypatch, reporter_cls, machine, spec) -> Service:
    service = Service()
    for name, module in _stub_modules(service).items():
        monkeypatch.setitem(sys.modules, name, module)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    reporter_cls.from_dict(spec).report(machine)
    return service


@pytest.mark.parametrize("spec", [POSTGRES, MLFLOW], ids=["postgres", "mlflow"])
def test_both_packages_record_the_same_rows_and_batches(spec, built_machine_dict, monkeypatch):
    ours = _record(monkeypatch, BaseReporter, Machine.from_dict(dict(built_machine_dict)), spec)
    theirs = _record(monkeypatch, JaxBaseReporter, JaxMachine.from_dict(dict(built_machine_dict)),
                     spec)
    assert ours.sql == theirs.sql and ours.mlflow == theirs.mlflow
    if spec is POSTGRES:
        upsert = [params for sql, params in ours.sql if sql.startswith("INSERT")]
        assert len(upsert) == 1
        name, dataset, model, metadata = upsert[0]
        assert (name, json.loads(dataset), json.loads(model), json.loads(metadata)) == (
            built_machine_dict["name"], built_machine_dict["dataset"],
            built_machine_dict["model"], built_machine_dict["metadata"])
    else:
        batches = [call for call in ours.mlflow if call[0] == "log_batch"]
        metrics, params = mlflow.extract_metrics_and_params(built_machine_dict)
        assert [(m["key"], m["value"]) for b in batches for m in b[2]] == metrics
        assert [(p["key"], p["value"]) for b in batches for p in b[3]] == params
        assert any(key.startswith("history-loss-epoch-") for key, _ in metrics)
        assert ours.mlflow[-1] == ("set_terminated", "run-1", "FINISHED")


def test_the_batches_and_their_limits_are_jax_s(built_machine_dict, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    scores = {f"metric-{i}": {"mean": 0.5, "std": 0.1, "max": 0.9, "min": 0.2}
              for i in range(80)}
    big = {"metadata": {"build_metadata": {"model": {
        "cross_validation": {"scores": scores, "cv_duration_sec": 12.5},
        "model_meta": {"history": {"loss": [float(i) for i in range(60)]}},
        "model_training_duration_sec": 3.2}}}}
    for machine_dict in (big, built_machine_dict, {}):
        assert mlflow.get_batch_kwargs(machine_dict) == jax_mlflow.get_batch_kwargs(machine_dict)
    calls = mlflow.get_batch_kwargs(big)
    assert len(calls) == 2 and all(len(c["metrics"]) <= mlflow.MAX_METRICS_PER_BATCH
                                   for c in calls)
    assert (mlflow.MAX_METRICS_PER_BATCH, mlflow.MAX_PARAMS_PER_BATCH) == (
        jax_mlflow.MAX_METRICS_PER_BATCH, jax_mlflow.MAX_PARAMS_PER_BATCH)
    assert mlflow.batch(list(range(5)), 2) == jax_mlflow.batch(list(range(5)), 2)
    with pytest.raises(ValueError):
        mlflow.batch([1], 0)


@pytest.mark.parametrize("library, spec", [("psycopg2", POSTGRES), ("mlflow", MLFLOW)])
def test_a_missing_library_raises_the_same_exception(library, spec, monkeypatch):
    monkeypatch.setitem(sys.modules, library, None)
    raised = []
    for base, machine in ((BaseReporter, Machine), (JaxBaseReporter, JaxMachine)):
        with pytest.raises(Exception) as caught:
            base.from_dict(spec).report(machine.from_config(CONFIG, "reporters"))
        raised.append((type(caught.value).__name__, str(caught.value),
                       [k.__name__ for k in type(caught.value).__mro__[1:3]]))
    assert raised[0] == raised[1]
    assert raised[0][2] == ["ReporterException", "Exception"]


def test_a_failed_connection_is_the_same_exception():
    def broken():
        raise OSError("no route to host")

    raised = []
    for module, machine in ((postgres, Machine), (jax_postgres, JaxMachine)):
        with pytest.raises(module.PostgresReporterException) as caught:
            module.PostgresReporter(connection_factory=broken).report(
                machine.from_config(CONFIG, "reporters"))
        raised.append(str(caught.value))
    assert raised[0] == raised[1] == "Could not connect to postgres: no route to host"
    with pytest.raises(ValueError, match="host= or connection_factory="):
        postgres.PostgresReporter()


def test_postgres_upserts_one_row_a_machine_on_a_dbapi_driver(tmp_path):
    db = str(tmp_path / "reporter.db")
    reporter = postgres.PostgresReporter(connection_factory=lambda: sqlite3.connect(db),
                                         paramstyle="?")
    machine = Machine.from_config(CONFIG, "reporters")
    reporter.report(machine)
    reporter.report(machine)
    rows = sqlite3.connect(db).execute("SELECT name, model FROM machine").fetchall()
    assert len(rows) == 1 and rows[0][0] == "report-machine"
    assert json.loads(rows[0][1]) == machine.to_dict()["model"]


@pytest.mark.parametrize("spec", [
    POSTGRES, MLFLOW, {"gordo_tpu.reporters.postgres.PostgresReporter": {
        "host": "db", "port": 6543, "user": "u", "database": "d", "paramstyle": "?"}},
    {"gordo.reporters.postgres.PostgresReporter": {"host": "db"}},
    {"gordo.reporters.mlflow.MlFlowReporter": {}},
], ids=["postgres", "mlflow", "postgres_all_args", "reference_postgres", "reference_mlflow"])
def test_to_dict_writes_the_jax_paths(spec, monkeypatch):
    monkeypatch.delenv("GORDO_TPU_POSTGRES_PASSWORD", raising=False)
    ours, theirs = BaseReporter.from_dict(spec), JaxBaseReporter.from_dict(spec)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.to_dict() == theirs.to_dict()
    path = next(iter(ours.to_dict()))
    assert path.startswith("gordo_tpu.reporters.")
    assert BaseReporter.from_dict(ours.to_dict()).to_dict() == ours.to_dict()


def test_reporters_in_a_machine_round_trip_with_jax_paths():
    config = {**CONFIG, "runtime": {"reporters": [POSTGRES, MLFLOW]}}
    ours, theirs = Machine.from_config(config, "p"), JaxMachine.from_config(config, "p")
    assert ours.to_dict()["runtime"]["reporters"] == theirs.to_dict()["runtime"]["reporters"]
    assert [type(BaseReporter.from_dict(s)) for s in ours.runtime["reporters"]] == [
        postgres.PostgresReporter, mlflow.MlFlowReporter]


def test_reporter_exceptions_exit_90_by_the_most_specific_class():
    for exc in (ReporterException("x"), postgres.PostgresReporterException("x"),
                mlflow.MlFlowReporterException("x")):
        assert cli.exit_code(exc) == 90
    for cls in (jax_postgres.PostgresReporterException, jax_mlflow.MlFlowReporterException):
        assert jax_exit_codes.exception_exit_code(cls) == 90


def test_a_reporter_without_its_library_exits_90_with_the_same_report(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    config = yaml.safe_dump({**CONFIG, "runtime": {"reporters": [POSTGRES]}})
    reports = []
    for name, run in (("jax", lambda argv: CliRunner().invoke(gordo, argv).exit_code),
                      ("port", lambda argv: cli.main([*argv, "--device", "cpu"]))):
        report = tmp_path / f"{name}.json"
        assert run(["build", config, str(tmp_path / name), "--exceptions-reporter-file",
                    str(report)]) == 90
        # the artifact is written before the reporters run
        assert (tmp_path / name / "metadata.json").exists()
        reports.append(json.loads(report.read_text()))
    assert reports[0] == reports[1]
    assert (reports[0]["type"], reports[0]["exit_code"]) == ("PostgresReporterException", 90)
    assert serializer.load_metadata(str(tmp_path / "port"))["runtime"]["reporters"] == [POSTGRES]


# -- the AOT decision: the port ships and loads no compiled program
def test_the_shipped_program_knobs_log_once_and_change_no_artifact(tmp_path, monkeypatch, caplog):
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.serializer import serializer as artifact

    monkeypatch.setattr(artifact, "_programs_noted", set())
    caplog.set_level(logging.INFO, logger=artifact.__name__)
    model, machine = ModelBuilder(Machine.from_config(CONFIG, "aot"), device="cpu").build()
    plain = tmp_path / "plain"
    serializer.dump(model, str(plain), tags=CONFIG["dataset"]["tags"],
                    metadata=machine.to_dict())
    serializer.load(str(plain), "cpu")
    monkeypatch.setenv("GORDO_TPU_SHIP_PROGRAMS", "1")
    monkeypatch.setenv("GORDO_TPU_LOAD_SHIPPED_PROGRAMS", "true")
    for i in range(2):
        serializer.dump(model, str(tmp_path / f"knob-{i}"), tags=CONFIG["dataset"]["tags"],
                        metadata=machine.to_dict())
        serializer.load(str(tmp_path / f"knob-{i}"), "cpu")
    notes = [r.getMessage() for r in caplog.records if "compiled serving program" in r.getMessage()]
    assert len(notes) == 2 and "GORDO_TPU_SHIP_PROGRAMS" in notes[0] and (
        "GORDO_TPU_LOAD_SHIPPED_PROGRAMS" in notes[1])
    for i in range(2):
        assert sorted(p.name for p in (tmp_path / f"knob-{i}").iterdir()) == sorted(
            p.name for p in plain.iterdir()) == sorted(artifact.ARTIFACT_FILES)
        assert (tmp_path / f"knob-{i}" / "params.npz").read_bytes() == (
            plain / "params.npz").read_bytes()
