"""
The bf16 dK/dV kernel's layout at the wide head-dim classes, on one NVIDIA
GPU: this tree's source against patched copies, each held to
``chip_smoke.head_dim_gates`` and timed in turns (source, variant, variant,
source) by CUDA events at T 512, causal.

    python3 scripts/torch_bf16_dkv_layouts.py   # from the repo root

The layouts (``LAYOUTS``, text patches of ``flash_attention_bwd_bf16.cu``
as ``scripts/torch_bf16_variants.py`` applies them):

- ``source``: each block sums every dK and dV column up to dh 128 (dK in a
  fresh accumulator up to 64 columns, in its own above), 64 columns at dh
  192 and 128 at 256;
- ``fresh_dk``: dK always in a fresh accumulator, and 64 columns a block
  above dh 128 (this PR's first layout);
- ``dc64_from128``: 64 columns a block from dh 128 on, dK fresh.

Prints the card's name and power limit, each layout's gate results by dh
(share of elements that differ from the twin), each (dh, BH) time of each
side's turns, and one JSON line, also written to
``chiprun_out/bf16_dkv_layouts.json``.
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DC = "  static constexpr int DC = DH == 256 ? 128 : DH > 128 ? 64 : DH;"
OWN_DK = "      if constexpr (DC > 64) {\n        if constexpr (Elem<E>::SCALED) {\n          float c0"
FRESH_DK = "      if constexpr (false) {\n        if constexpr (Elem<E>::SCALED) {\n          float c0"
LAYOUTS = {
    "source": [],
    "fresh_dk": [("flash_attention_bwd_bf16.cu", DC,
                  "  static constexpr int DC = DH > 128 ? 64 : DH;"),
                 ("flash_attention_bwd_bf16.cu", OWN_DK, FRESH_DK)],
    "dc64_from128": [("flash_attention_bwd_bf16.cu", DC,
                      "  static constexpr int DC = DH >= 128 ? 64 : DH;")],
}
HEAD_DIMS = (96, 128, 192, 256)
BH = (1024, 4096)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bf16_dkv_layouts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import chip_smoke as cs
    import torch_bf16_variants as variants
    from gordo_tpu_torch.ops import flash_attention as fa

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = list(LAYOUTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: variants._build(n, LAYOUTS[n]), names)))
    kernels = {name: variants._kernels(libs) for name, libs in built.items()}
    gates = {}
    for name in names:
        variants._use(kernels[name])
        try:
            gates[name] = cs.head_dim_gates("bfloat16")["dkv"]
        except AssertionError as exc:
            gates[name] = f"failed: {exc}"
        print(f"{name}: dK/dV gates by dh {gates[name]}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    times = {}
    for dh in HEAD_DIMS:
        for bh in BH:
            q, k, v, do = (torch.randn((bh, 512, dh), device="cuda", generator=g).bfloat16()
                           for _ in range(4))
            o, lse = fa.flash_attention_forward(q, k, v, True)
            for name in names[1:]:
                turns = {"source": [], name: []}
                for side in ("source", name, name, "source"):
                    variants._use(kernels[side])
                    turns[side].append(cs._time_ms(
                        lambda: fa.launch_dkv(q, k, v, o, lse, do, True), 10))
                times[f"{name} dh {dh} BH {bh}"] = turns
                print(f"bf16 dK/dV at ({bh}, 512, {dh}) causal on {card}: source "
                      f"{turns['source']} ms, {name} {turns[name]} ms", flush=True)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    result = {"card": card, "gates": gates, "times": times}
    out = REPO / "chiprun_out" / "bf16_dkv_layouts.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
