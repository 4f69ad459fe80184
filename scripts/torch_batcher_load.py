"""
Batched against unbatched serving of the batcher traffic, on one NVIDIA GPU.

    python3 scripts/torch_batcher_load.py [float32|bfloat16] [REQUESTS] [TURNS]   # from the repo root

Serves ``chip_smoke.py``'s eight ``transformer-ae-512`` batcher artifacts
(their own seeded weights, at the given compute dtype, float32 unless
named) through the port's server on the card and drives its traffic: 16
users, each POSTing 600-row anomaly requests (89 windows, padded to 128)
in the rectangular body, round robin over the models. Batching off
(``GORDO_TPU_SERVING_BATCH=0``) and forced on (``1``) take turns, 0, 1,
1, 0, ... for TURNS (3) pairs; each turn starts a fresh batcher, sends a
warm-up wave of one request a user, then times REQUESTS (8) requests a
user: per-call p50 and p99 (host clock around each POST, the clients in
the server's own process) and windows a second, with every answer 200.
Prints the card's name and power limit, each turn, and one JSON line with
the turns and each mode's medians.
"""

import json
import os
import statistics
import sys
import threading
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
USERS = 16
ROWS = 600


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_batcher_load: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.server import batcher
    from gordo_tpu_torch.server.server import make_server

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = sys.argv[1] if len(sys.argv) > 1 else "float32"
    requests = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    turns = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    collection = REPO / "build" / "batcher_load" / dtype / "1"
    names = [f"batcher-m{m}" for m in range(chip_smoke.BATCHER_MODELS)]
    for m, name in enumerate(names):
        spec = chip_smoke.write_artifact(collection, name=name, seed=chip_smoke.SEED + 100 + m,
                                         compute_dtype=dtype)[0]
    n_out = ROWS - spec.lookback_window + 1
    rng = np.random.RandomState(chip_smoke.SEED + 12)

    def wave(per_user: int) -> list:
        return [(names[(u + r) % len(names)],
                 chip_smoke._rect_body(chip_smoke._series(ROWS, 700 * (r * USERS + u), rng)))
                for r in range(per_user) for u in range(USERS)]

    warm, timed = wave(1), wave(requests)
    server = make_server("127.0.0.1", 0, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    project = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/load"
    results = []
    try:
        for mode in ["0", "1", "1", "0"] * (turns // 2) + ["0", "1"] * (turns % 2):
            os.environ["GORDO_TPU_SERVING_BATCH"] = mode
            batcher.reset_batcher()
            chip_smoke._drive(project, warm, USERS)
            fused = batcher.peek_batcher()
            calls = fused.stats["device_calls"] if fused else 0
            answers, wall = chip_smoke._drive(project, timed, USERS)
            if any(a is None or a[0] != 200 for a in answers):
                raise AssertionError(f"mode {mode}: statuses {[a and a[0] for a in answers]}")
            ms = sorted(a[2] for a in answers)
            turn = {"mode": mode, "p50_ms": ms[len(ms) // 2], "p99_ms": ms[int(0.99 * len(ms))],
                    "windows_per_s": len(timed) * n_out / wall, "wall_s": wall,
                    "fused_calls": fused.stats["device_calls"] - calls if fused else None}
            results.append(turn)
            print(f"{dtype} on {card}: {turn}", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.reset_batcher()
    summary = {mode: {key: statistics.median(t[key] for t in results if t["mode"] == mode)
                      for key in ("p50_ms", "p99_ms", "windows_per_s")}
               for mode in ("0", "1")}
    print(json.dumps({"card": card, "compute_dtype": dtype, "users": USERS, "rows": ROWS,
                      "requests_per_user": requests, "turns": results, "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
