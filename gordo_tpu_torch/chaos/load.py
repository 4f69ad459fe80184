"""
The load the chaos conductor drives: the port's copy of what
``gordo_tpu/chaos/conductor.py`` takes from ``benchmarks/load_test.py``,
over the port's latency histograms (observability/latency.py). From the
same parameters and seed it gives the same arrival offsets and keys.

- :func:`build_schedule`: arrival offsets of a shaped open-loop schedule
  (``flat``, ``diurnal``, ``flash``);
- :func:`skewed_key_picker`: the arrival-indexed key pattern, with an
  optional hot key;
- :func:`run_open_schedule`: open-loop load over an explicit schedule,
  each request timed from its intended send time (no coordinated
  omission), with a per-request log for the invariant checkers;
- :func:`run_chaff`: abuse-shaped connections that are not requests
  (slow loris, scanner).
"""

import heapq
import math
import socket
import threading
import time

from ..observability.latency import LatencyHistogram

# how many slowest-request trace ids each worker keeps
DEFAULT_TOP_SLOW = 5

# the schedule shapes build_schedule understands (the scenario vocabulary)
SCHEDULE_SHAPES = ("flat", "diurnal", "flash")


class WorkerStats:
    """One worker thread's private accounting — no locks on the hot path;
    merged across workers after the run."""

    def __init__(self, top_slow: int = DEFAULT_TOP_SLOW, keep_log: bool = False):
        self.hist = LatencyHistogram()
        self.phase_hists: dict = {}
        self.errors: list = []
        self.slowest: list = []  # min-heap of (latency_s, trace_id)
        self.top_slow = top_slow
        self.requests = 0
        self.warmup_requests = 0
        # per-request response log for the chaos conductor's invariant
        # checkers: (intended_offset_s, latency_s, error, key). Off by
        # default — the plain load paths keep their no-allocation hot loop.
        self.log: list = [] if keep_log else None

    def observe(
        self, latency_s, error, trace_id, phases,
        measured: bool, expected_interval_s=None,
        offset_s=None, key=None,
    ):
        if self.log is not None:
            self.log.append((offset_s, latency_s, error, key))
        if error is not None:
            self.errors.append(error)
            return
        if not measured:
            self.warmup_requests += 1
            return
        self.requests += 1
        if expected_interval_s:
            self.hist.record_with_expected_interval(
                latency_s, expected_interval_s, trace_id
            )
        else:
            self.hist.record(latency_s, trace_id)
        for name, duration in phases.items():
            hist = self.phase_hists.get(name)
            if hist is None:
                hist = self.phase_hists.setdefault(name, LatencyHistogram())
            hist.record(duration)
        if trace_id:
            heapq.heappush(self.slowest, (latency_s, trace_id))
            if len(self.slowest) > self.top_slow:
                heapq.heappop(self.slowest)


def _run_threads(worker, stats_list):
    threads = [
        threading.Thread(target=worker, args=(stats,), daemon=True)
        for stats in stats_list
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def build_schedule(
    shape: str, qps: float, duration: float, warmup: float = 0.0,
    peak: float = 4.0, flash_at: float = None, flash_len: float = 1.0,
    period: float = None, amp: float = 0.5,
) -> list:
    """Arrival offsets (seconds from t0, sorted) for a shaped open-loop
    schedule (``flat`` is the plain open loop's ``i/qps`` grid):

    - ``flat`` — constant rate, arrival i at ``i/qps``.
    - ``diurnal`` — a compressed day: rate ``qps * (1 + amp*sin)`` over
      ``period`` seconds (default: the whole window is one cycle),
      integrated in closed form so arrival times are exact, not sampled.
    - ``flash`` — flat base rate plus a flash crowd: an extra ``peak``x
      burst of evenly spaced arrivals inside ``[flash_at, flash_at +
      flash_len)`` (default: centered in the measure window).

    Deterministic by construction: same parameters, same schedule."""
    if qps <= 0:
        raise ValueError("qps must be > 0")
    horizon = warmup + duration
    total = max(1, int(round(horizon * qps)))
    if shape == "flat":
        return [i / qps for i in range(total)]
    if shape == "diurnal":
        cycle = period or max(horizon, 1e-9)
        amp = min(max(float(amp), 0.0), 0.95)
        # cumulative arrivals N(t) = qps*(t - amp*cycle/(2pi)*(cos(2pi
        # t/cycle) - 1)); invert per-arrival by bisection on the strictly
        # increasing N(t) — exact to float precision, no rate sampling
        two_pi = 2.0 * math.pi

        def cum(t: float) -> float:
            return qps * (
                t - amp * cycle / two_pi * (math.cos(two_pi * t / cycle) - 1.0)
            )

        total = max(1, int(round(cum(horizon))))
        offsets = []
        for i in range(total):
            lo, hi = 0.0, horizon
            for _ in range(60):  # < 1ns resolution over any sane horizon
                mid = (lo + hi) / 2.0
                if cum(mid) < i:
                    lo = mid
                else:
                    hi = mid
            offsets.append((lo + hi) / 2.0)
        return offsets
    if shape == "flash":
        base = [i / qps for i in range(total)]
        if flash_at is None:
            flash_at = warmup + duration / 2.0 - flash_len / 2.0
        flash_at = max(0.0, min(flash_at, horizon - 1e-9))
        flash_len = max(min(flash_len, horizon - flash_at), 1e-9)
        burst_n = max(1, int(round(flash_len * qps * (peak - 1.0))))
        burst = [flash_at + j * flash_len / burst_n for j in range(burst_n)]
        return sorted(base + burst)
    raise ValueError(f"unknown schedule shape {shape!r} (one of {SCHEDULE_SHAPES})")


def skewed_key_picker(keys, hot_pct: float = 0.0, seed: int = 0):
    """Deterministic per-arrival key selection with optional hot-key skew:
    ``hot_pct`` percent of arrivals hit one 'hot' key (chosen by seed),
    the rest round-robin the full set — a fixed pattern (Knuth
    multiplicative hash of the arrival index), NOT randomness, so two
    runs of the same scenario target identical keys."""
    keys = list(keys)
    if not keys:
        raise ValueError("need at least one key")
    hot = keys[seed % len(keys)]

    def pick(i: int):
        if hot_pct > 0 and ((i * 2654435761 + seed) >> 7) % 100 < hot_pct:
            return hot
        return keys[i % len(keys)]

    return pick


def run_open_schedule(
    send, users: int, schedule, first_measured: int = 0,
    top_slow: int = DEFAULT_TOP_SLOW, keep_log: bool = False,
    key_of=None, stride=None, t0: float = None, stop=None,
):
    """Open-loop load over an EXPLICIT arrival schedule (offsets from t0).

    The generalized form of ``run_open``: same coordinated-omission-safe
    accounting (latency measured from the intended send time), but the
    schedule is a first-class argument so shaped loads (build_schedule),
    hot-key skew (``key_of(i)`` picks the target; send must then accept
    the key), shard slicing (``stride=(k, n)`` owns arrival indices
    ``i ≡ k mod n``), and a shared cross-process ``t0`` all compose.
    ``stop`` (a threading.Event) abandons unsent arrivals early."""
    stats_list = [WorkerStats(top_slow, keep_log) for _ in range(users)]
    if t0 is None:
        t0 = time.monotonic()
    lock = threading.Lock()
    cursor = [0]
    k, n = stride or (0, 1)
    slots = len(range(k, len(schedule), n))

    def worker(stats):
        while True:
            with lock:
                j = cursor[0]
                cursor[0] += 1
            if j >= slots or (stop is not None and stop.is_set()):
                return
            i = k + j * n
            offset = schedule[i]
            intended = t0 + offset
            now = time.monotonic()
            if intended > now:
                time.sleep(intended - now)
            if key_of is not None:
                error, trace_id, phases = send(key_of(i))
            else:
                error, trace_id, phases = send()
            latency = time.monotonic() - intended
            stats.observe(
                latency, error, trace_id, phases,
                measured=i >= first_measured, offset_s=offset, key=(
                    key_of(i) if key_of is not None else None
                ),
            )

    _run_threads(worker, stats_list)
    horizon = schedule[first_measured] if first_measured < len(schedule) else 0.0
    wall = time.monotonic() - (t0 + horizon)
    return stats_list, max(wall, 1e-9)


def run_chaff(
    host: str, port: int, kind: str, conns: int, duration: float,
    stop=None,
):
    """Abuse-shaped connections that are NOT requests: these never count
    toward availability (the invariant checkers exclude them by
    construction — they are reported in their own block).

    - ``slow_loris`` — open a connection, dribble one header byte per
      ~250ms, never finishing the request: ties up per-connection parser
      state until the server's idle/header timeout closes it.
    - ``scanner`` — junk-path probes (the background radiation of any
      exposed port): each expects a fast 4xx and a surviving server.

    Returns counts: opened / server_closed / responses / errors."""
    report = {"kind": kind, "conns": conns, "opened": 0,
              "server_closed": 0, "responses": 0, "errors": 0}
    lock = threading.Lock()
    paths = ("/admin.php", "/.env", "/wp-login.php", "/cgi-bin/test",
             "/etc/passwd", "/robots.txt.bak")
    stop_at = time.monotonic() + duration

    def loris():
        try:
            with socket.create_connection((host, port), timeout=5) as sock:
                with lock:
                    report["opened"] += 1
                sock.sendall(b"GET / HTTP/1.1\r\nHost: chaff\r\nX-Dribble: ")
                sock.settimeout(0.25)
                while time.monotonic() < stop_at:
                    if stop is not None and stop.is_set():
                        return
                    try:
                        sock.sendall(b"z")
                    except OSError:
                        with lock:
                            report["server_closed"] += 1
                        return
                    try:
                        if sock.recv(256) == b"":
                            with lock:
                                report["server_closed"] += 1
                            return
                    except socket.timeout:
                        pass
                    except OSError:
                        with lock:
                            report["server_closed"] += 1
                        return
        except OSError:
            with lock:
                report["errors"] += 1

    def scanner(idx: int):
        i = 0
        while time.monotonic() < stop_at:
            if stop is not None and stop.is_set():
                return
            path = paths[(idx + i) % len(paths)]
            i += 1
            try:
                with socket.create_connection((host, port), timeout=5) as sock:
                    with lock:
                        report["opened"] += 1
                    sock.sendall(
                        f"GET {path} HTTP/1.1\r\nHost: chaff\r\n"
                        f"Connection: close\r\n\r\n".encode()
                    )
                    sock.settimeout(5)
                    if sock.recv(512):
                        with lock:
                            report["responses"] += 1
            except OSError:
                with lock:
                    report["errors"] += 1
            time.sleep(0.1)

    threads = [
        threading.Thread(
            target=(loris if kind == "slow_loris" else scanner),
            args=(() if kind == "slow_loris" else (i,)),
            daemon=True,
        )
        for i in range(conns)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return report
