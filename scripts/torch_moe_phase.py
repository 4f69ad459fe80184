"""
``chip_smoke.py``'s Switch-MoE phase alone, on one NVIDIA GPU: after the
kernels and the native codec are built, moe-transformer-ae-512 is built
through the CLI in float32 and bf16 (``cli_model_build``), both artifacts
are served direct and fused with the routing-first gates (``moe_served``),
the MoE fleet runs (``moe_fleet``: stacked buckets against serial, then a
``batch-build`` of two moe-transformer-ae-512 and two moe_model_144
machines), and the flash kernels are timed at dh 16 at moe_model_144's
stacked step (``head_dim_times``). A quicker way than the whole smoke run
to iterate on the MoE family.

    python3 scripts/torch_moe_phase.py        # from the repo root

Each part prints its gates and numbers as ``chip_smoke.py`` does; a part
that fails prints its traceback and the next one runs (serving needs the
builds). The last line is one JSON object of the parts' results, with
each part's seconds.
"""

import concurrent.futures
import json
import shutil
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_moe_phase: no CUDA device", file=sys.stderr)
        return 2
    from gordo_tpu_torch import native
    from gordo_tpu_torch.ops import _build

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.load)
        _build.build_all()
        native_build.result()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    root = cs.REPO / "build" / "moe_phase"
    shutil.rmtree(root, ignore_errors=True)
    collection = root / "collection"
    collection.mkdir(parents=True)
    out, failed = {}, False
    parts = [(f"build_{dtype}", lambda dtype=dtype: cs.cli_model_build(
        card, collection, dtype, cs.MOE_CONFIG, "moe-transformer-ae-512")) for dtype in cs.COUNTERS]
    parts += [("served", lambda: cs.moe_served(card, collection, {
                  dtype: out[f"build_{dtype}"]["name"] for dtype in cs.COUNTERS})),
              ("fleet", lambda: cs.moe_fleet(card, root)),
              ("times_dh16", lambda: {dtype: cs.head_dim_times(
                  card, dtype, dims=(16,), bhs=cs.MOE_TIMED_BH,
                  t=cs.MOE144_CONFIG["lookback_window"]) for dtype in cs.COUNTERS})]
    for name, fn in parts:
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 -- reported, then the next part runs
            traceback.print_exc()
            out[name] = {"failed": repr(exc)}
            failed = True
        out[name]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"{name}: {out[name]['phase_s']:.1f} s", flush=True)
    print(card)
    print(json.dumps({"moe": out}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
