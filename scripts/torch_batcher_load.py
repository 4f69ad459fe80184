"""
Batched against unbatched serving of the batcher traffic, on one NVIDIA GPU.

    python3 scripts/torch_batcher_load.py [float32|bfloat16] [REQUESTS] [TURNS]
        [--lane default|thread|loop] [--keep-alive]      # from the repo root

Serves ``chip_smoke.py``'s eight ``transformer-ae-512`` batcher artifacts
(their own seeded weights, at the given compute dtype, float32 unless
named) through one front end of the port's server on the card: ``default``
(the server's own HTTP/1.1 handler), ``thread`` (the socket fast lane, a
thread a connection) or ``loop`` (the fast lane's event loop), and drives
its traffic from a child process (``chip_smoke.lane_client``): 16 users,
each POSTing 600-row anomaly requests (89 windows, padded to 128) in the
rectangular body, round robin over the models, over one keep-alive
connection a user with ``--keep-alive``, else a new connection a request.
Batching off (``GORDO_TPU_SERVING_BATCH=0``) and forced on (``1``) take
turns, 0, 1, 1, 0, ... for TURNS (3) pairs; each turn starts a fresh
batcher, sends a warm-up wave of one request a user, then times REQUESTS
(8) requests a user: per-call p50 and p99 (the client's clock around each
POST) and windows a second, with every answer 200, and the connections the
server accepted. Prints the card's name and power limit, each turn, and one
JSON line with the turns and each mode's medians.
"""

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
USERS = 16
ROWS = 600


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("dtype", nargs="?", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("requests", nargs="?", type=int, default=8)
    parser.add_argument("turns", nargs="?", type=int, default=3)
    parser.add_argument("--lane", default="default", choices=["default", "thread", "loop"])
    parser.add_argument("--keep-alive", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_batcher_load: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.server import batcher

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = REPO / "build" / "batcher_load" / args.dtype
    collection = root / "1"
    names = [f"batcher-m{m}" for m in range(chip_smoke.BATCHER_MODELS)]
    for m, name in enumerate(names):
        spec = chip_smoke.write_artifact(collection, name=name, seed=chip_smoke.SEED + 100 + m,
                                         compute_dtype=args.dtype)[0]
    n_out = ROWS - spec.lookback_window + 1
    rng = np.random.RandomState(chip_smoke.SEED + 12)

    def wave(per_user: int) -> list:
        return [[f"/gordo/v0/load/{names[(u + r) % len(names)]}/anomaly/prediction",
                 chip_smoke._rect_body(chip_smoke._series(ROWS, 700 * (r * USERS + u), rng))
                 .decode()]
                for r in range(per_user) for u in range(USERS)]

    job = {"phases": [{"name": name, "requests": requests, "users": USERS,
                       "keep_alive": args.keep_alive, "bodies": 0}
                      for name, requests in (("warm", wave(1)), ("timed", wave(args.requests)))]}
    lane = chip_smoke._Lane(args.lane, collection, "cuda")
    job["port"] = lane.port
    results = []
    try:
        for mode in ["0", "1", "1", "0"] * (args.turns // 2) + ["0", "1"] * (args.turns % 2):
            os.environ["GORDO_TPU_SERVING_BATCH"] = mode
            batcher.reset_batcher()
            accepted = lane.server.accepted
            out = chip_smoke._run_clients(job, root)
            fused = batcher.peek_batcher()
            answers = out["timed"]["results"] + out["warm"]["results"]
            if any(a[0] != 200 for a in answers):
                raise AssertionError(f"mode {mode}: statuses {[a[0] for a in answers]}")
            ms = sorted(a[1] for a in out["timed"]["results"])
            n_timed = len(job["phases"][1]["requests"])
            turn = {"mode": mode, "p50_ms": ms[len(ms) // 2], "p99_ms": ms[int(0.99 * len(ms))],
                    "windows_per_s": n_timed * n_out / out["timed"]["wall_s"],
                    "wall_s": out["timed"]["wall_s"],
                    "connections": lane.server.accepted - accepted,
                    "fused_calls": fused.stats["device_calls"] if fused else None,
                    "fuse_widths": sorted({n for n, _ in fused.calls}) if fused else None}
            results.append(turn)
            print(f"{args.dtype}, {args.lane} lane, keep-alive {args.keep_alive} on {card}: "
                  f"{turn}", flush=True)
    finally:
        lane.close()
        batcher.reset_batcher()
    summary = {mode: {key: statistics.median(t[key] for t in results if t["mode"] == mode)
                      for key in ("p50_ms", "p99_ms", "windows_per_s")}
               for mode in ("0", "1")}
    print(json.dumps({"card": card, "compute_dtype": args.dtype, "lane": args.lane,
                      "keep_alive": args.keep_alive, "users": USERS, "rows": ROWS,
                      "requests_per_user": args.requests, "turns": results,
                      "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
