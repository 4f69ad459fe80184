"""
Prediction forwarders: callables the client invokes per prediction batch.
The port's counterpart of ``gordo_tpu/client/forwarders.py``, over
:class:`~gordo_tpu_torch.models.utils.RawFrame` batches.

``ForwardPredictionsIntoInflux`` writes the same InfluxDB 1.x line protocol
as the JAX forwarder, byte for byte, over the port's ``HTTPSession`` (the
same lazy, lock-guarded session; one ``CREATE DATABASE``, after a ``DROP``
with ``destination_influx_recreate``, whatever the threads).
``ForwardPredictionsToDisk`` appends ``<dir>/<machine>/batch-NNNNNN.parquet``
files through the port's own parquet writer (util/parquet.py), the column
names flattened with ``|`` as the JAX forwarder flattens them, so that
``pd.read_parquet`` gives back what it gives for the JAX forwarder's files.
"""

import abc
import logging
import os
import threading
from datetime import datetime
from typing import Any, Optional

import numpy as np

from ..models.utils import RawFrame, timestamp_columns
from ..util import parquet
from ..util.utils import parse_service_uri

logger = logging.getLogger(__name__)


class PredictionForwarder(abc.ABC):
    @abc.abstractmethod
    def forward(
        self, predictions: RawFrame, machine: str, metadata: dict
    ) -> None:
        """Deliver one batch of predictions for one machine."""

    def __call__(
        self,
        predictions: RawFrame,
        machine: Any = None,
        metadata: Optional[dict] = None,
    ) -> None:
        self.forward(predictions, str(machine), metadata or {})


def _flat_columns(predictions: RawFrame) -> list:
    """``(name, values)`` of each column of ``predictions`` as the JAX disk
    forwarder names them: ``start`` and ``end`` (ISO strings), then each
    group's sub-columns, ``top|sub`` (``top`` where the sub is empty)."""
    start, end = timestamp_columns(predictions.index, predictions.frequency)
    columns = [("start", start), ("end", end)]
    for top, subs, values in predictions.groups:
        values = np.asarray(values, np.float64)
        columns += [("|".join(part for part in (str(top), str(sub)) if part), values[:, j])
                    for j, sub in enumerate(subs)]
    return columns


class ForwardPredictionsToDisk(PredictionForwarder):
    """Append prediction batches as parquet files under dir/machine/."""

    def __init__(self, destination_dir: str):
        self.destination_dir = destination_dir
        self._counters: dict = {}

    def forward(
        self, predictions: RawFrame, machine: str, metadata: dict
    ) -> None:
        machine_dir = os.path.join(self.destination_dir, machine)
        os.makedirs(machine_dir, exist_ok=True)
        n = self._counters.get(machine, 0)
        self._counters[machine] = n + 1
        path = os.path.join(machine_dir, f"batch-{n:06d}.parquet")
        parquet.write_frame(path, _flat_columns(predictions), predictions.index)
        logger.info("Forwarded %d rows for %s -> %s", len(predictions), machine, path)


def _lp_escape(value: str, *, is_measurement: bool = False) -> str:
    """InfluxDB line-protocol escaping for measurements/tag values/field keys."""
    out = str(value).replace("\\", "\\\\").replace(",", "\\,").replace(" ", "\\ ")
    if not is_measurement:
        out = out.replace("=", "\\=")
    return out


def _epoch_ns(ts: datetime) -> int:
    return parquet.epoch_micros(ts) * 1000


class ForwardPredictionsIntoInflux(PredictionForwarder):
    """
    Write prediction/anomaly blocks into InfluxDB over its 1.x HTTP write
    API (line protocol) — no client library needed; pairs with the workflow's
    per-project influx side-deployment and the dataset layer's
    InfluxDataProvider, which reads the same database back.

    Each group of the frame becomes a measurement (``total-anomaly-scaled``,
    ``tag-anomaly-unscaled``, ...) tagged with the machine name; its
    sub-columns become fields (``value`` for an empty one). The ``start`` and
    ``end`` strings are not written: timestamps are the line's own time
    component. Non-finite values are left out, and a line without a field.
    """

    def __init__(
        self,
        destination_influx_uri: str = "",
        destination_influx_api_key: str = "",
        destination_influx_recreate: bool = False,
        session=None,
        batch_lines: int = 5000,
    ):
        # accepts both <host>:<port>/<db> (reference client convention) and
        # scheme-prefixed uris
        scheme, host, port, database = parse_service_uri(
            destination_influx_uri, default_path="gordo"
        )
        self.base_url = f"{scheme or 'http'}://{host}:{port}"
        self.database = database
        self.api_key = destination_influx_api_key
        self.recreate = destination_influx_recreate
        self.batch_lines = batch_lines
        self._session = session
        self._prepared = False
        # one forwarder is shared by Client.predict's thread-pool fan-out:
        # without the lock, two threads could both enter _prepare and a
        # second DROP DATABASE (recreate=True) would silently delete
        # predictions the first thread already forwarded. RLock: _prepare
        # holds it while its first post touches the lazy `session`
        # property, which re-acquires on first create
        self._prepare_lock = threading.RLock()

    @property
    def session(self):
        if self._session is None:
            with self._prepare_lock:
                if self._session is None:
                    from .io import HTTPSession

                    # requests.Session()'s: no retries
                    self._session = HTTPSession(n_retries=0)
        return self._session

    def _headers(self) -> dict:
        return (
            {"Authorization": self.api_key} if self.api_key else {}
        )

    def _prepare(self):
        with self._prepare_lock:
            if self._prepared:
                return
            statements = (
                [f'DROP DATABASE "{self.database}"'] if self.recreate else []
            ) + [f'CREATE DATABASE "{self.database}"']
            for q in statements:
                resp = self.session.post(
                    f"{self.base_url}/query",
                    params={"q": q},
                    headers=self._headers(),
                )
                status = getattr(resp, "status_code", 200)
                if status >= 300:
                    raise IOError(
                        f"InfluxDB statement {q!r} failed ({status}): "
                        f"{getattr(resp, 'text', '')[:300]}"
                    )
            self._prepared = True

    def _write(self, lines) -> None:
        resp = self.session.post(
            f"{self.base_url}/write",
            params={"db": self.database, "precision": "ns"},
            data="\n".join(lines).encode(),
            headers=self._headers(),
        )
        status = getattr(resp, "status_code", 204)
        if status >= 300:
            raise IOError(
                f"InfluxDB write failed ({status}): "
                f"{getattr(resp, 'text', '')[:300]}"
            )

    def forward(
        self, predictions: RawFrame, machine: str, metadata: dict
    ) -> None:
        self._prepare()
        index = predictions.index
        if index and all(isinstance(ts, datetime) for ts in index):
            times_ns = [_epoch_ns(ts) for ts in index]
        else:
            times_ns = list(range(len(index)))
        machine_tag = _lp_escape(machine)

        lines = []
        for measurement, subs, values in predictions.groups:
            meas = _lp_escape(measurement, is_measurement=True)
            field_keys = [_lp_escape(str(c) or "value") for c in subs]
            values = np.asarray(values, np.float64)
            for i, t_ns in enumerate(times_ns):
                fields = ",".join(
                    f"{key}={float(val)}"
                    for key, val in zip(field_keys, values[i])
                    # NaN/inf are invalid line protocol and reject the batch
                    if np.isfinite(val)
                )
                if not fields:
                    continue
                lines.append(f"{meas},machine={machine_tag} {fields} {int(t_ns)}")
                if len(lines) >= self.batch_lines:
                    self._write(lines)
                    lines = []
        if lines:
            self._write(lines)
