"""
The prediction client: the port's counterpart of
``gordo_tpu/client/client.py``. It predicts a date range for some or all
machines of a project, fetching each machine's rows through its own dataset
config (or the client's ``data_provider``) and POSTing them in batches; it
reads metadata and revisions and downloads models. Per-machine work fans
out over a thread pool, as the JAX client's does.

Bodies are JSON: ``use_parquet=True`` is refused at construction, as the
port's server refuses ``?format=parquet``. Without a ``session`` the client
makes an :class:`~gordo_tpu_torch.client.io.HTTPSession` (``requests``' retry
adapter's behaviour on ``http.client``); every call carries the
``(connect, read)`` timeout (``GORDO_TPU_CLIENT_TIMEOUT``) and a W3C
``traceparent``.
"""

import concurrent.futures
import logging
import os
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .. import serializer
from ..dataset.datasets import GordoBaseDataset
from ..models.utils import Frame, RawFrame
from ..observability import tracing
from . import io as _io_mod
from .io import HTTPSession, NotFound, _handle_response
from .utils import PredictionResult

logger = logging.getLogger(__name__)

# default (connect, read) timeout: the session's retries only cover requests
# that FAIL — a server that accepts the connection and then hangs would block
# a fleet download forever without a read timeout
DEFAULT_TIMEOUT: Tuple[float, float] = (10.0, 300.0)
TIMEOUT_ENV = "GORDO_TPU_CLIENT_TIMEOUT"
PARQUET_REFUSAL = ("use_parquet=True is not supported by gordo_tpu_torch: it needs pyarrow, "
                   "which is not installed; the client sends JSON (use_parquet=False)")


def _timeout_from_env() -> Tuple[float, float]:
    """Parse ``GORDO_TPU_CLIENT_TIMEOUT``: ``"connect,read"`` seconds, or a
    single number applied to both. Invalid values keep the default."""
    raw = os.environ.get(TIMEOUT_ENV)
    if not raw:
        return DEFAULT_TIMEOUT
    try:
        parts = [float(p) for p in raw.split(",")]
    except ValueError:
        logger.warning(
            "Invalid %s=%r; using default %s", TIMEOUT_ENV, raw, DEFAULT_TIMEOUT
        )
        return DEFAULT_TIMEOUT
    if len(parts) == 1:
        return (parts[0], parts[0])
    return (parts[0], parts[1])


def _rows(frame: Frame, start: int, stop: int) -> Frame:
    return Frame(frame.values[start:stop], frame.columns, frame.index[start:stop], frame.tz)


class Client:
    """Query a gordo model server for predictions and artifacts. Models
    downloaded with :meth:`download_model` load on ``device`` (``cuda``
    unless ``"cpu"``)."""

    def __init__(
        self,
        project: str,
        host: str = "localhost",
        port: int = 443,
        scheme: str = "https",
        revision: Optional[str] = None,
        prediction_forwarder: Optional[
            Callable[[RawFrame, Any, dict], None]
        ] = None,
        batch_size: int = 100000,
        parallelism: int = 10,
        n_retries: int = 5,
        use_parquet: bool = False,
        data_provider: Optional[Any] = None,
        session: Optional[Any] = None,
        timeout: Optional[Union[float, Tuple[float, float]]] = None,
        device=None,
    ):
        if use_parquet:
            raise ValueError(PARQUET_REFUSAL)
        self.project_name = project
        self.base_url = f"{scheme}://{host}:{port}/gordo/v0/{project}"
        self.revision = revision
        self.prediction_forwarder = prediction_forwarder
        self.batch_size = batch_size
        self.parallelism = max(1, parallelism)
        self.use_parquet = use_parquet
        self.data_provider = data_provider
        self.device = device
        # (connect, read) timeout carried by EVERY session call, including
        # the _fan_out fetchers — without it a hung server wedges a fleet
        # download despite the retries (they never see a response)
        if timeout is None:
            timeout = _timeout_from_env()
        self.timeout = (
            (timeout, timeout) if isinstance(timeout, (int, float)) else timeout
        )
        self.session = session if session is not None else HTTPSession(n_retries=n_retries)
        # machines whose model is not an anomaly detector fall back to the
        # base prediction endpoint (detected on first 422, cached per name)
        self._plain_prediction_machines: set = set()

    # ------------------------------------------------------------- queries
    def _params(self, revision: Optional[str] = None) -> dict:
        revision = revision or self.revision
        return {"revision": revision} if revision else {}

    def _trace_headers(self) -> dict:
        """W3C ``traceparent`` for one outbound call: continue the active
        trace context when the caller established one (a traced CLI run),
        else mint a fresh trace per request. The server echoes the trace
        id back as ``X-Gordo-Trace``, so a client-side failure log names
        the exact trace to pull from the server's /debug/flight."""
        ctx = tracing.current() or tracing.fresh_context()
        return {"traceparent": tracing.format_traceparent(ctx)}

    def _get(self, path: str, revision: Optional[str] = None, params: bool = True):
        return self.session.get(
            f"{self.base_url}/{path}",
            params=self._params(revision) if params else None,
            headers=self._trace_headers(),
            timeout=self.timeout,
        )

    def get_revisions(self) -> dict:
        return _handle_response(self._get("revisions", params=False), "revisions")

    def get_available_machines(self, revision: Optional[str] = None) -> dict:
        return _handle_response(self._get("models", revision), "model list")

    def get_machine_names(self, revision: Optional[str] = None) -> List[str]:
        return self.get_available_machines(revision).get("models", [])

    def get_metadata(
        self,
        revision: Optional[str] = None,
        targets: Optional[List[str]] = None,
        _resolved: bool = False,
    ) -> Dict[str, dict]:
        """Metadata for every (or the given) machine, keyed by name."""
        names = (
            list(targets)
            if _resolved and targets
            else self._resolve_targets(targets, revision)
        )

        def fetch(name):
            return _handle_response(self._get(f"{name}/metadata", revision),
                                    f"metadata for {name}").get("metadata", {})

        return self._fan_out(fetch, names)

    def _download(self, name: str, revision: Optional[str]) -> bytes:
        return _handle_response(self._get(f"{name}/download-model", revision),
                                f"model for {name}")

    def download_model(
        self,
        revision: Optional[str] = None,
        targets: Optional[List[str]] = None,
    ) -> Dict[str, Any]:
        """Download and deserialize models, keyed by machine name."""
        names = self._resolve_targets(targets, revision)
        return self._fan_out(
            lambda name: serializer.loads(self._download(name, revision), self.device), names)

    def download_artifacts(
        self,
        output_dir: str,
        revision: Optional[str] = None,
        targets: Optional[List[str]] = None,
    ) -> Dict[str, str]:
        """Download models and write each one's artifact files, as served,
        into ``output_dir/<machine>``; returns the directories by name."""
        names = self._resolve_targets(targets, revision)

        def fetch(name):
            directory = os.path.join(output_dir, name)
            serializer.unpack(self._download(name, revision), directory)
            return directory

        return self._fan_out(fetch, names)

    def _fan_out(self, fetch, names: List[str]) -> Dict[str, Any]:
        """Run one GET per machine over the client's thread pool — at
        fleet scale (1000s of machines), a serial loop would spend minutes
        in back-to-back round trips before predict's parallel phase even
        starts. Order-preserving; the first failure cancels the unstarted
        remainder and propagates promptly (pool.map would drain every
        queued doomed request — each with retry backoff — before raising).
        The session opens a connection a request, so it is thread-safe."""
        if len(names) <= 1:
            return {name: fetch(name) for name in names}
        results: Dict[str, Any] = {}
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(self.parallelism, len(names))
        ) as pool:
            futures = {pool.submit(fetch, name): name for name in names}
            try:
                for future in concurrent.futures.as_completed(futures):
                    results[futures[future]] = future.result()
            except BaseException:
                for future in futures:
                    future.cancel()
                raise
        return {name: results[name] for name in names}

    def _resolve_targets(
        self, targets: Optional[List[str]], revision: Optional[str]
    ) -> List[str]:
        available = self.get_machine_names(revision)
        if not targets:
            return available
        missing = set(targets) - set(available)
        if missing:
            raise NotFound(
                f"Machines {sorted(missing)} not found in project "
                f"{self.project_name} (available: {sorted(available)})"
            )
        return list(targets)

    # ------------------------------------------------------------- predict
    def predict(
        self,
        start: Union[str, datetime],
        end: Union[str, datetime],
        targets: Optional[List[str]] = None,
        revision: Optional[str] = None,
    ) -> List[PredictionResult]:
        """
        Predict/anomaly-score the given time range for each target machine.

        Data is fetched via each machine's own dataset config (or this
        client's ``data_provider`` override), POSTed in batches, and the
        responses concatenated per machine.
        """
        names = self._resolve_targets(targets, revision)
        metadata = self.get_metadata(revision, names, _resolved=True)
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=self.parallelism
        ) as pool:
            futures = {
                pool.submit(
                    self.predict_single_machine,
                    name,
                    start,
                    end,
                    revision,
                    metadata[name],
                ): name
                for name in names
            }
            results = []
            for future in concurrent.futures.as_completed(futures):
                name = futures[future]
                try:
                    results.append(future.result())
                except Exception as exc:
                    logger.exception("Prediction failed for %s", name)
                    results.append(
                        PredictionResult(name, None, [str(exc)])
                    )
        return results

    def predict_single_machine(
        self,
        name: str,
        start: Union[str, datetime],
        end: Union[str, datetime],
        revision: Optional[str],
        metadata: dict,
    ) -> PredictionResult:
        X, y = self._get_data(metadata, start, end)
        frames: List[RawFrame] = []
        errors: List[str] = []
        for batch_start in range(0, len(X.index), self.batch_size):
            stop = batch_start + self.batch_size
            X_batch = _rows(X, batch_start, stop)
            y_batch = _rows(y, batch_start, stop) if y is not None else X_batch
            try:
                frame = self._post_prediction(
                    name, X_batch, y_batch, revision
                )
                frames.append(frame)
                if self.prediction_forwarder is not None:
                    # positional call: the declared type is a positional
                    # Callable[[RawFrame, Any, dict], None] — keyword
                    # names would break any forwarder whose parameters
                    # aren't spelled exactly predictions/machine/metadata
                    self.prediction_forwarder(frame, name, metadata)
            except Exception as exc:
                errors.append(f"batch@{batch_start}: {exc}")
        predictions = RawFrame.concat(frames) if frames else None
        return PredictionResult(name, predictions, errors)

    def _get_data(self, metadata: dict, start, end) -> Tuple[Frame, Frame]:
        dataset_config = dict(
            metadata.get("dataset", {})
            or metadata.get("build_metadata", {})
            .get("dataset", {})
            .get("dataset_meta", {})
        )
        dataset_config["train_start_date"] = start
        dataset_config["train_end_date"] = end
        if self.data_provider is not None:
            dataset_config["data_provider"] = self.data_provider
        dataset = GordoBaseDataset.from_dict(dataset_config)
        return dataset.get_data()

    def _post_prediction(
        self,
        name: str,
        X: Frame,
        y: Optional[Frame],
        revision: Optional[str],
    ) -> RawFrame:
        from .io import HttpUnprocessableEntity

        if name in self._plain_prediction_machines:
            endpoint = "prediction"
        else:
            endpoint = "anomaly/prediction"
        try:
            return self._post_to(name, endpoint, X, y, revision)
        except HttpUnprocessableEntity:
            if endpoint == "prediction":
                raise
            self._plain_prediction_machines.add(name)
            return self._post_to(name, "prediction", X, y, revision)

    def _post_to(
        self,
        name: str,
        endpoint: str,
        X: Frame,
        y: Optional[Frame],
        revision: Optional[str],
    ) -> RawFrame:
        url = f"{self.base_url}/{name}/{endpoint}"
        params = self._params(revision)
        headers = self._trace_headers()
        payload = {"X": X.to_dict()}
        if y is not None:
            payload["y"] = y.to_dict()

        def _attempt():
            resp = self.session.post(
                url, json=payload, params=params, headers=headers,
                timeout=self.timeout,
            )
            return _handle_response(resp, f"prediction for {name}")

        # a 503 naming a Retry-After horizon (shed gate, open breaker,
        # gateway with no live nodes) is retried within the fault policy's
        # attempt budget instead of surfacing immediately
        content = _io_mod.call_with_retry_after(_attempt)
        return RawFrame.from_dict(content["data"])
