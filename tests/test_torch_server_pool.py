"""
The port's prefork serving pool (``run-server --workers``, the arbiter in
``gordo_tpu_torch/server/server.py``) as real processes on the CPU
(``--device cpu``), after ``tests/gordo_tpu/test_server_pool.py``: it
serves and survives a worker's SIGKILL (respawning to full strength), the
fast lane serves under it, the fleet sums come from the telemetry shards
without Prometheus and with it (the pool's ``/metrics`` and the sidecar's),
a dead worker's shard leaves them, a boot failure trips the throttle, the
drain finishes the requests in flight, and the arbiter touches no
``torch.cuda`` before it forks.

Every wait is on an event (a response, a log line, a process's exit) and
bounded; each test has a deadline of its own (``DEADLINE_S``, an interval
timer that fails the test).
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from test_torch_resilience import write_artifacts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90.0
ANOMALY = "/gordo/v0/p/m-0/anomaly/prediction"


@pytest.fixture(autouse=True)
def _deadline():
    """Fail the test past DEADLINE_S instead of hanging the run."""
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S:.0f} s deadline")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    path = tmp_path_factory.mktemp("pool") / "1"
    path.mkdir()
    write_artifacts(path, ["m-0", "m-1"])
    return path


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _env(collection, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("GORDO_TPU_", "ENABLE_PROMETHEUS", "GORDO_SERVER_"))}
    env.update(PYTHONPATH=REPO, MODEL_COLLECTION_DIR=str(collection), PROJECT="pool-test",
               **extra)
    return env


def _get(url: str, timeout: float = 10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def _post(url: str, body: bytes, timeout: float = 60.0):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _body(rows: int = 40) -> bytes:
    values = [[0.1 * ((i + j) % 10) for j in range(8)] for i in range(rows)]
    return json.dumps({"X": values, "y": values}).encode()


def _until(probe, what: str, timeout: float = 60.0, step: float = 0.05):
    """Poll ``probe`` (an exception counts as not yet) until it returns a
    truthy value, which is returned; fail after ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            value = probe()
            if value:
                return value
        except (OSError, urllib.error.URLError, ValueError):
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(step)


def _children(pid: int) -> list:
    proc = subprocess.run(["pgrep", "-P", str(pid)], capture_output=True, text=True, timeout=10)
    assert proc.returncode in (0, 1), proc.stderr
    return sorted(int(p) for p in proc.stdout.split())


class Pool:
    """``python -m gordo_tpu_torch run-server`` in a session of its own."""

    def __init__(self, collection, tmp_path, *args, workers: int = 2, **env):
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.log = tmp_path / f"pool-{self.port}.log"
        with open(self.log, "w") as fh:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "gordo_tpu_torch", "--log-level", "INFO", "run-server",
                 "--host", "127.0.0.1", "--port", str(self.port), "--device", "cpu",
                 "--workers", str(workers), *args],
                cwd=REPO, env=_env(collection, **env), stdout=subprocess.DEVNULL, stderr=fh,
                start_new_session=True)

    def text(self) -> str:
        return self.log.read_text()

    def wait_up(self, workers: int = 2) -> None:
        def up():
            assert self.proc.poll() is None, self.text()[-3000:]
            return _get(f"{self.base}/healthcheck", timeout=5)[0] == 200 and \
                self.text().count("Serving ") >= workers
        _until(up, "the pool to answer", timeout=60)

    def workers(self) -> list:
        return _children(self.proc.pid)

    def stop(self, sig=signal.SIGTERM, timeout: float = 30.0) -> int:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, sig)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


@pytest.fixture()
def pools():
    started = []
    yield started
    for pool in started:
        pool.stop(signal.SIGKILL)


def test_pool_serves_warms_and_survives_a_worker_kill(collection, tmp_path, pools):
    pool = Pool(collection, tmp_path, "--warmup", GORDO_TPU_DEBUG_ENDPOINTS="1")
    pools.append(pool)
    pool.wait_up()
    assert pool.text().count("serving warmup: 2 model(s), 1 architecture(s)") == 2
    status, body = _get(f"{pool.base}/debug/vars")
    report = json.loads(body)["warmup"]
    assert report["models"] == 2 and report["failed"] == [] and report["errors"] == {}
    (arch,) = report["architectures"].values()
    assert arch["models"] == ["m-0", "m-1"] and arch["rows"] == [128, 1024]
    assert _post(pool.base + ANOMALY, _body())[0] == 200
    workers = pool.workers()
    assert len(workers) == 2
    os.kill(workers[0], signal.SIGKILL)
    _until(lambda: _post(pool.base + ANOMALY, _body(), timeout=30)[0] == 200,
           "the pool to answer after a worker's SIGKILL")
    _until(lambda: len([p for p in pool.workers() if p != workers[0]]) == 2,
           "the pool to respawn to two workers")
    assert "spawning replacement" in pool.text()


def test_pool_fast_lane_serves_hot_and_fallback_routes(collection, tmp_path, pools):
    pool = Pool(collection, tmp_path, GORDO_TPU_FAST_LANE="1")
    pools.append(pool)
    pool.wait_up()
    assert pool.text().count("(EventLoopServer)") == 2
    status, body = _post(pool.base + ANOMALY, _body())
    assert status == 200 and "total-anomaly-scaled" in json.loads(body)["data"]
    status, body = _get(f"{pool.base}/gordo/v0/p/models")
    assert status == 200 and json.loads(body)["models"] == ["m-0", "m-1"]


def _prediction_sum(text: str, family: str) -> float:
    pattern = re.compile(rf"^{family}\{{([^}}]*)\}}\s+([0-9.eE+-]+)$", re.MULTILINE)
    return sum(float(v) for labels, v in pattern.findall(text)
               if "prediction" in labels and "worker=" not in labels)


@pytest.mark.parametrize("prometheus", [False, True], ids=["shards", "prometheus"])
def test_pool_metrics_sum_every_worker(collection, tmp_path, pools, prometheus):
    """Whichever worker takes the scrape, /metrics counts every request the
    pool answered; with ENABLE_PROMETHEUS the request families and the
    sidecar count them too; a dead worker's shard leaves the sum."""
    telemetry_dir = tmp_path / "telemetry"
    telemetry_dir.mkdir()
    env = {"GORDO_TPU_TELEMETRY_DIR": str(telemetry_dir), "GORDO_TPU_DEBUG_ENDPOINTS": "1"}
    if prometheus:
        env["ENABLE_PROMETHEUS"] = "1"
    pool = Pool(collection, tmp_path, "--no-batch-predicts", **env)
    pools.append(pool)
    pool.wait_up()
    n = 8
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        _post(pool.base + ANOMALY, _body())[0])) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results == [200] * n
    family = "gordo_server_requests_total" if prometheus else "gordo_server_fleet_requests_total"
    scrape = lambda: _get(f"{pool.base}/metrics")[1].decode()  # noqa: E731
    # each worker's last requests reach its shard within the flush interval
    _until(lambda: _prediction_sum(scrape(), family) == n, f"{family} to reach {n}", timeout=20)
    text = scrape()
    assert re.search(r"^gordo_server_fleet_workers 2(\.0)?$", text, re.MULTILINE), text[-2000:]
    assert _prediction_sum(text, "gordo_server_fleet_request_seconds_count") == n
    if prometheus:
        assert _prediction_sum(text, "gordo_server_request_duration_seconds_count") == n
        sidecar_port = _free_port()
        sidecar = subprocess.Popen(
            [sys.executable, "-c", "from gordo_tpu_torch.server.prometheus.server import "
             f"run_metrics_server; run_metrics_server('127.0.0.1', {sidecar_port})"],
            cwd=REPO, env=_env(collection, **env), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, start_new_session=True)
        try:
            side = _until(lambda: _get(f"http://127.0.0.1:{sidecar_port}/metrics")[1].decode(),
                          "the sidecar to answer")
            assert _prediction_sum(side, family) == n
            assert _get(f"http://127.0.0.1:{sidecar_port}/healthcheck")[0] == 200
        finally:
            sidecar.kill()
            sidecar.wait(timeout=10)
    # the slo fleet view sums the shards' windows too
    fleet = json.loads(_get(f"{pool.base}/debug/slo")[1])["fleet"]
    assert fleet["models"]["m-0"]["5m"]["requests"] == n
    # a killed worker's shard is reaped: the sum keeps only the survivor's
    victim = pool.workers()[0]
    shards = {f.name for f in telemetry_dir.iterdir()}
    assert f"telemetry_{victim}.shard" in shards
    os.kill(victim, signal.SIGKILL)
    _until(lambda: not (telemetry_dir / f"telemetry_{victim}.shard").exists(),
           "the dead worker's shard to be reaped")
    assert _prediction_sum(scrape(), family) < n


def test_a_boot_failure_trips_the_throttle(collection, tmp_path):
    """Workers that die while warming up, later than the fast-death
    interval and before they are ready, count as boot failures: after five
    the arbiter stops respawning and exits with the error."""
    plan = {"rules": [{"site": "serve_model_load", "machine": "m-0", "error": "wedge",
                       "seconds": 2.2}, {"site": "serve_model_load", "machine": "m-1",
                                         "error": "die"}]}
    pool = Pool(collection, tmp_path, "--warmup", "--no-batch-predicts",
                GORDO_TPU_FAULT_PLAN=json.dumps(plan), GORDO_TPU_WARMUP_ROWS="1")
    try:
        rc = pool.proc.wait(timeout=80)
    finally:
        pool.stop(signal.SIGKILL)
    assert rc != 0
    text = pool.text()
    assert "consecutive boot failures" in text and "all workers failed at boot" in text
    assert text.count("fault plan: host death") >= 5


def test_the_drain_finishes_the_requests_in_flight(collection, tmp_path, pools):
    """SIGTERM to the arbiter while every request is inside its handler
    (each wedged in the predict phase): every one answers 200, the pool
    exits 0 within the drain budget, and the port refuses connections."""
    plan = {"rules": [{"site": "serve_predict", "times": -1, "error": "wedge", "seconds": 2}]}
    pool = Pool(collection, tmp_path, "--no-batch-predicts", GORDO_TPU_DRAIN_S="30",
                GORDO_TPU_FAULT_PLAN=json.dumps(plan))
    pools.append(pool)
    pool.wait_up()
    n, results = 4, []
    threads = [threading.Thread(target=lambda: results.append(_post(pool.base + ANOMALY,
                                                                    _body())))
               for _ in range(n)]
    for t in threads:
        t.start()
    _until(lambda: pool.text().count("fault plan: wedging serve_predict") == n,
           "every request to be inside its handler", step=0.01)
    started = time.monotonic()
    os.kill(pool.proc.pid, signal.SIGTERM)
    for t in threads:
        t.join(timeout=30)
    assert [status for status, _ in results] == [200] * n
    assert all(json.loads(body)["data"] for _, body in results)
    assert pool.proc.wait(timeout=30) == 0
    assert time.monotonic() - started < 30
    assert pool.text().count("drain complete") == 2
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(f"{pool.base}/healthcheck", timeout=5)


ARBITER = """
import os, sys, torch
arbiter = os.getpid()
def forbidden(name):
    real = eval(name)
    def guard(*args, **kwargs):
        if os.getpid() == arbiter:
            sys.stderr.write(f"ARBITER TOUCHED {{name}}\\n")
            sys.stderr.flush()
            os._exit(99)
        return real(*args, **kwargs)
    return guard
for name in ("is_available", "device_count", "get_device_name", "init", "current_device",
             "synchronize", "set_device"):
    setattr(torch.cuda, name, forbidden("torch.cuda." + name))
if hasattr(torch._C, "_cuda_getDeviceCount"):
    torch._C._cuda_getDeviceCount = forbidden("torch._C._cuda_getDeviceCount")
from gordo_tpu_torch.ops import _build
_build.build_all = lambda: sys.stderr.write("KERNELS BUILT BEFORE FORK\\n")
from gordo_tpu_torch.server.server import run_server
run_server("127.0.0.1", {port}, {device!r}, None, None, 2, 50, False)
"""


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_arbiter_touches_no_cuda_before_forking(collection, tmp_path, device):
    """Every ``torch.cuda`` entry point raises in the arbiter's process: the
    CPU pool starts and serves; the ``cuda`` pool builds the kernels once,
    and its workers (after the fork) find no card here and fail with the
    error, which the throttle counts, with no CPU fallback."""
    port = _free_port()
    log = tmp_path / f"arbiter-{device}.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", ARBITER.format(port=port, device=device)],
                                cwd=REPO, env=_env(collection), stdout=subprocess.DEVNULL,
                                stderr=fh, start_new_session=True)
    try:
        if device == "cpu":
            _until(lambda: _get(f"http://127.0.0.1:{port}/healthcheck")[0] == 200,
                   "the CPU pool to answer")
            assert _post(f"http://127.0.0.1:{port}{ANOMALY}", _body())[0] == 200
            os.kill(proc.pid, signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        else:
            assert proc.wait(timeout=60) != 0
            text = log.read_text()
            assert "KERNELS BUILT BEFORE FORK" in text
            assert "CUDA is not available" in text and "all workers failed at boot" in text
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert "ARBITER TOUCHED" not in log.read_text()
