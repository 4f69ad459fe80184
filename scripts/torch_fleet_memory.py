"""
Peak device memory of the fleet trainer's stacked program by the number of
machines in it (``BatchedModelBuilder``'s ``chunk_size``), on one NVIDIA
GPU.

    python3 scripts/torch_fleet_memory.py [MACHINES ...]   # from the repo root

For each compute dtype (float32, then bfloat16) and each machine count M
(8 32 64 128 256 unless named), runs ``parallel/batch_trainer.run_bucket``
on ``chip_smoke.py``'s ``transformer-ae-512`` (seeded weights, M machines'
seeded rows) cut to one stage: STEPS stacked training steps at batch 32,
then one fold predict of a full chunk (PREDICT_WINDOWS machine-windows a
launch). Those are the two places where the program's memory peaks: the
training step grows with M, the predict chunk does not (up to 1,024
machines). Prints each M's peak memory (``torch.cuda.max_memory_allocated``)
and ms per stacked step on the host clock, or that it ran out of memory
(larger M are then skipped).

Then the OOM bisection on the card: BISECT_MACHINES float32
``transformer-ae-512`` machines (each its own tags, cut to 2,400 rows)
built by ``BatchedModelBuilder`` in one chunk of all of them, more than
the card holds: the chunk must be halved (``oom_bisections`` above 0) and
every machine must still come out of the stacked program. Prints the
card's name and power limit and one JSON line.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
STEPS = 3
DEFAULT_MACHINES = (8, 32, 64, 128, 256)
# the bisection check's machines and their last row: 2,400 ten-minute rows,
# 126 steps a machine (folds of 3, 22 and 41 steps, a fit of 60)
BISECT_MACHINES = 128
BISECT_END = "2020-01-17T16:00:00+00:00"


def program_peak(spec, n_machines: int, device) -> dict:
    """Peak memory and ms per stacked step of one cut stage of the bucket
    program over ``n_machines`` machines; ``{"oom": True}`` where it runs
    out of memory."""
    import torch

    from gordo_tpu_torch.parallel import batch_trainer as bt

    batch = 32
    test_len = bt.PREDICT_WINDOWS + spec.lookback_window - 1
    n_valid = STEPS * batch
    n_rows = max(n_valid + spec.lookback_window - 1, test_len)
    stages = [bt.Stage(n_rows, n_valid, n_valid, batch, 0, test_len)]
    rng = np.random.RandomState(n_machines)
    X = rng.rand(n_machines, n_rows, 8).astype(np.float32)
    inits, orders = bt.draw_inputs(list(range(n_machines)), spec, stages, 1, True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    epochs = []
    run_masked_epoch = bt.run_masked_epoch

    def timed_epoch(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_masked_epoch(*args)
        torch.cuda.synchronize()
        epochs.append(time.perf_counter() - t0)
        return out

    bt.run_masked_epoch = timed_epoch
    failed = False
    try:
        bt.run_bucket(spec, X, X, stages, 1, False, inits, orders, device)
        torch.cuda.synchronize()
    except torch.OutOfMemoryError:
        failed = True
    finally:
        bt.run_masked_epoch = run_masked_epoch
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    if failed:
        return {"machines": n_machines, "oom": True}
    return {"machines": n_machines, "oom": False, "peak_gib": peak,
            "ms_per_stacked_step": 1e3 * epochs[0] / STEPS,
            "ms_per_machine_step": 1e3 * epochs[0] / STEPS / n_machines}


def bisection_check(root: Path, n_machines: int) -> dict:
    """``n_machines`` float32 ``transformer-ae-512`` machines (each its own
    tags, cut to 2,400 rows) built in one chunk of all of them, which does
    not fit on the card: it must be halved until it fits, every machine
    still from the stacked program."""
    import torch

    import chip_smoke
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.parallel import batch_trainer as bt

    configs = []
    for m in range(n_machines):
        config = chip_smoke.build_config(
            f"fleet-memory-m{m}", tags=[f"m{m}-tag-{j}" for j in range(len(chip_smoke.TAGS))])
        config["dataset"]["train_end_date"] = BISECT_END
        configs.append(config)
    machines = [Machine.from_config(c, "fleet-memory") for c in configs]
    builder = bt.BatchedModelBuilder(machines, chunk_size=n_machines, output_dir=str(root),
                                     device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built = builder.build()
    seconds = time.perf_counter() - t0
    result = {"machines": n_machines, "built": len(built),
              "oom_bisections": builder.oom_bisections, "serial": builder.serial_built,
              "quarantined": [r.to_dict() for r in builder.quarantine_records],
              "seconds": seconds, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"{n_machines} float32 machines in one chunk: {result}", flush=True)
    if len(built) != n_machines or not builder.oom_bisections or builder.serial_built:
        raise AssertionError("the chunk was not bisected into stacked programs")
    return result


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fleet_memory: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.models.models import TransformerAutoEncoder

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = [int(a) for a in argv] or list(DEFAULT_MACHINES)
    device = torch.device("cuda")
    rows = {}
    for dtype in ("float32", "bfloat16"):
        spec = TransformerAutoEncoder(**chip_smoke.CONFIG, compute_dtype=dtype).build_spec(
            len(chip_smoke.TAGS), len(chip_smoke.TAGS))
        program_peak(spec, 1, device)  # warm-up: the kernels' build, cuBLAS's first calls
        rows[dtype] = []
        for n in counts:
            row = program_peak(spec, n, device)
            rows[dtype].append(row)
            print(f"{dtype}, {n} machines on {card}: {row}", flush=True)
            if row["oom"]:
                break
    root = REPO / "build" / "fleet_memory"
    bisection = bisection_check(root, BISECT_MACHINES)
    print(card)
    print(json.dumps({"card": card, "steps": STEPS, "by_dtype": rows, "bisection": bisection}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
