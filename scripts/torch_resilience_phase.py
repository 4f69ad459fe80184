"""
``chip_smoke.py``'s resilience phase alone, on one NVIDIA GPU: after the
kernels and the native codec are built, a seeded ``transformer-ae-512``
artifact and its bf16 twin are written as the batcher phases write theirs
(``write_artifact``, ``batcher-m0``), and ``resilience_path`` runs over
them: the serving pool with and without ``--warmup``, on one worker and on
two, its gates (warm-up reports, restacks, answers, ``/metrics`` and the
sidecar, device traces, a worker's SIGKILL, the drain), then in this
process the admission gate, a deadline, the breaker and output guard, and
the latency attribution with the perf sentinel. A quicker way than the
whole smoke run to iterate on the serving pool.

    python3 scripts/torch_resilience_phase.py           # from the repo root
    python3 scripts/torch_resilience_phase.py --cold    # on an empty build directory

With ``--cold`` it runs no phase: on a checkout whose kernels were never
built (``build/gordo_tpu_torch`` absent; the artifacts are written on the
CPU so that nothing builds them first) it starts ``run-server --workers 2
--warmup``, whose arbiter builds every kernel before it forks, and prints
the seconds from the start to the first 200 of a full-width request and
that request's latency.

It prints the card's name and power limit; the last line is one JSON object
of its results. A failed gate raises.
"""

import argparse
import concurrent.futures
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _artifacts(root: Path, device: str) -> Path:
    batcher_root = root / "batcher"
    for dtype, estimator in (("float32", {}), ("bfloat16", {"compute_dtype": "bfloat16"})):
        collection = batcher_root / dtype / "1"
        collection.mkdir(parents=True)
        cs.write_artifact(collection, device, name="batcher-m0", seed=cs.SEED + 100,
                          **estimator)
    return batcher_root


def cold(card: str, root: Path) -> dict:
    """The first 200 of a two-worker pool with --warmup on an empty build
    directory (the arbiter builds the kernels)."""
    import numpy as np

    from gordo_tpu_torch.ops import _build

    if _build.BUILD_ROOT.exists() and any(_build.BUILD_ROOT.iterdir()):
        raise SystemExit(f"{_build.BUILD_ROOT} is not empty: --cold needs a fresh checkout")
    batcher_root = _artifacts(root, "cpu")
    collection = root / "1"
    collection.mkdir(parents=True)
    for model, dtype in zip(cs.RES_MODELS, ("float32", "bfloat16")):
        (collection / model).symlink_to(batcher_root / dtype / "1" / "batcher-m0")
    body = cs._rect_body(cs._series(cs.FULL_ROWS, 140000, np.random.RandomState(cs.SEED + 29)))
    pool = cs._Pool(root, collection, 2, True, "cuda", "cold-build")
    try:
        url = f"{pool.base}/gordo/v0/{cs.OBS_PROJECT}/{cs.RES_MODELS[0]}/anomaly/prediction"
        first = pool.first_200(url, body, timeout=900)
    finally:
        pool.stop()
    built = sorted(p.name for p in _build._build_dir().glob("*.so"))
    print(f"cold start on {card}: first 200 after {first['start_to_first_200_s']:.1f} s "
          f"({first['first_request_ms']:.1f} ms) with --warmup on an empty build directory; "
          f"built {built}", flush=True)
    return {"cold_first_200": first, "built": built}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cold", action="store_true",
                        help="time the first 200 on an empty build directory, no phase")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_resilience_phase: no CUDA device", file=sys.stderr)
        return 2
    card = cs._card()
    print(card, flush=True)
    root = cs.REPO / "build" / "chip_smoke_resilience_alone"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    if args.cold:
        result = cold(card, root)
    else:
        from gordo_tpu_torch import native
        from gordo_tpu_torch.ops import _build

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            native_build = pool.submit(native.load)
            _build.build_all()
            native_build.result()
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
        batcher_root = _artifacts(root, "cuda")
        result = cs.resilience_path(card, root / "resilience", batcher_root)
    print(card)
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
