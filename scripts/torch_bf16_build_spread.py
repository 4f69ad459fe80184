"""
The held-out error of the bf16 machine's build over seeds, with the bf16
kernels of this tree and of another tree, on one NVIDIA GPU.

    python3 scripts/torch_bf16_build_spread.py [--other CSRC] [--seeds N]   # from the repo root

Builds ``chip_smoke.BUILD_CONFIG_BF16`` (transformer-ae-512-bf16: 3-fold CV
and a fit over 6,144 RandomDataset rows, 420 steps) through ``ModelBuilder``
with its evaluation seed set to 0 .. N-1 (default 5; the seed draws the
initial weights and the batch order), each time:

- ``source``: with this tree's bf16 kernels;
- ``other``: with the bf16 kernels of the sources in ``CSRC`` (a copy of
  ``gordo_tpu_torch/ops/csrc`` from another commit, e.g. unpacked from
  ``git archive <commit> gordo_tpu_torch/ops/csrc`` under ``build/``),
  compiled with the port's nvcc flags and put in place of the wrappers'
  kernels; left out without ``--other``.

(Plain attention is no witness at this size: its (windows, heads, T, T)
scores in the build's predicts over 8,192 windows outgrow the card.)

Prints the card's name and power limit, the held-out scaled MSE
(``chip_smoke.held_out_mse``) of each build, each side's mean, standard
deviation, smallest and largest, with ``--other`` the paired differences
(source minus other, seed by seed: their mean, standard deviation, paired
t and the seeds where the source reads higher), and one JSON line.
"""

import argparse
import json
import shutil
import statistics
import sys
from datetime import datetime, timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "bf16_build_spread"


def main(argv) -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--other", type=Path, default=None)
    parser.add_argument("--seeds", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bf16_build_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import chip_smoke
    import torch_bf16_variants as variants
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.ops import flash_attention as fa

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    source = {"forward": fa._bf16_kernel(), "dq": fa._bf16_dq_kernel(),
              "dkv": fa._bf16_dkv_kernel()}
    sides = {"source": source}
    if args.other is not None:
        sides["other"] = variants._kernels(variants._build("other", [], args.other.resolve()))
        variants._use(source)

    dataset = chip_smoke.BUILD_CONFIG_BF16["dataset"]
    n_rows = (datetime.fromisoformat(dataset["train_end_date"])
              - datetime.fromisoformat(dataset["train_start_date"])) // timedelta(minutes=10)
    spec = TransformerAutoEncoder(**chip_smoke.CONFIG, compute_dtype="bfloat16").build_spec(
        len(chip_smoke.TAGS), len(chip_smoke.TAGS))
    mse = {side: [] for side in sides}
    for seed in range(args.seeds):
        for side, kernels in sides.items():
            config = chip_smoke.build_config("transformer-ae-512-bf16", compute_dtype="bfloat16")
            config["evaluation"]["seed"] = seed
            variants._use(kernels)
            output, register = OUT / f"{side}-{seed}", OUT / "register"
            shutil.rmtree(output, ignore_errors=True)
            shutil.rmtree(register, ignore_errors=True)  # no build from the cache
            model, _ = ModelBuilder(Machine.from_config(config, "bf16-spread"), "cuda").build(
                output, register)
            err = chip_smoke.held_out_mse(model, spec, n_rows)
            mse[side].append(err["trained"])
            print(f"seed {seed} {side} on {card}: held-out scaled MSE {err['trained']:.6f} "
                  f"(seeded initial weights {err['seeded']:.6f})", flush=True)
    summary = {side: {"mean": statistics.fmean(x), "sd": statistics.stdev(x) if len(x) > 1
                      else None, "min": min(x), "max": max(x)} for side, x in mse.items()}
    for side, s in summary.items():
        print(f"{side}: mean {s['mean']:.6f}, sd {s['sd']}, min {s['min']:.6f}, "
              f"max {s['max']:.6f}", flush=True)
    if "other" in mse and args.seeds > 1:
        # the seeds pair the two sides: the same weights and batch order
        diff = [a - b for a, b in zip(mse["source"], mse["other"])]
        sd = statistics.stdev(diff)
        paired = {"mean": statistics.fmean(diff), "sd": sd,
                  "t": statistics.fmean(diff) / (sd / len(diff) ** 0.5) if sd > 0 else None,
                  "source_higher": sum(d > 0 for d in diff)}
        summary["source_minus_other"] = paired
        print(f"source - other: mean {paired['mean']:.6f}, sd {sd:.6f}, paired t "
              f"{paired['t']} ({len(diff) - 1} df), source higher on "
              f"{paired['source_higher']} of {len(diff)} seeds", flush=True)
    print(json.dumps({"card": card, "seeds": args.seeds, "held_out_mse": mse,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
