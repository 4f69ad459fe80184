"""
``PostgresReporter``: upsert a built machine into a ``machine`` table. The
port's copy of ``gordo_tpu/reporters/postgres.py``: the same table (the
name as primary key; the dataset, model and metadata as JSON documents),
the same row and upsert, on the DB-API, so that any conforming driver
works. ``psycopg2`` is imported only when the reporter connects, and only
where no ``connection_factory`` is given (tests and the card's smoke run
hand one in); the password comes from ``GORDO_TPU_POSTGRES_PASSWORD`` unless
given.
"""

import json
import logging
import os
from typing import Any, Callable, Optional

from ..util.utils import capture_args
from .base import BaseReporter, ReporterException

logger = logging.getLogger(__name__)


class PostgresReporterException(ReporterException):
    pass


CREATE_TABLE_SQL = """
CREATE TABLE IF NOT EXISTS machine (
    name TEXT PRIMARY KEY,
    dataset TEXT NOT NULL,
    model TEXT NOT NULL,
    metadata TEXT NOT NULL
)
"""

UPSERT_SQL = """
INSERT INTO machine (name, dataset, model, metadata)
VALUES ({p}, {p}, {p}, {p})
ON CONFLICT (name) DO UPDATE SET
    dataset = excluded.dataset,
    model = excluded.model,
    metadata = excluded.metadata
"""


def _psycopg2_factory(host, port, user, password, database):
    def connect():
        try:
            import psycopg2
        except ImportError as exc:
            raise PostgresReporterException(
                "psycopg2 is not installed; pass connection_factory= to "
                "PostgresReporter or install a postgres driver"
            ) from exc
        return psycopg2.connect(host=host, port=port, user=user, password=password,
                                dbname=database)

    return connect


class PostgresReporter(BaseReporter):
    """Declared in a machine's runtime as
    ``gordo_tpu.reporters.postgres.PostgresReporter: {host: ...}``."""

    @capture_args
    def __init__(
        self,
        host: Optional[str] = None,
        port: int = 5432,
        user: str = "postgres",
        password: Optional[str] = None,
        database: str = "postgres",
        connection_factory: Optional[Callable[[], Any]] = None,
        paramstyle: str = "%s",
    ):
        if host is None and connection_factory is None:
            raise ValueError("PostgresReporter needs host= or connection_factory=")
        if password is None:
            # the workflow's postgres injects its generated secret here, so
            # that configs never carry the credential
            password = os.environ.get("GORDO_TPU_POSTGRES_PASSWORD")
        self.host = host
        self.port = port
        self.user = user
        self.database = database
        self.paramstyle = paramstyle
        self._connect = connection_factory or _psycopg2_factory(
            host, port, user, password, database)

    def report(self, machine) -> None:
        try:
            conn = self._connect()
        except PostgresReporterException:
            raise
        except Exception as exc:
            raise PostgresReporterException(f"Could not connect to postgres: {exc}") from exc
        try:
            cursor = conn.cursor()
            cursor.execute(CREATE_TABLE_SQL)
            machine_dict = machine.to_dict()
            cursor.execute(
                UPSERT_SQL.format(p=self.paramstyle),
                (
                    machine.name,
                    json.dumps(machine_dict.get("dataset", {})),
                    json.dumps(machine_dict.get("model", {})),
                    json.dumps(machine_dict.get("metadata", {})),
                ),
            )
            conn.commit()
            logger.info("Reported machine %s to postgres", machine.name)
        except Exception as exc:
            raise PostgresReporterException(
                f"Failed reporting machine {machine.name}: {exc}") from exc
        finally:
            conn.close()
