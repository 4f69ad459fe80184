"""
The bf16 flash backward's elements that miss one bf16 ulp (+1e-6) of the
float64 result, for the dQ and dK/dV kernels and for the float32 plain twin,
on one NVIDIA GPU.

    python3 scripts/torch_flash_gate_misses.py [--extra BH,T,DH ...]   # from the repo root

The inputs are those of ``chip_smoke.head_dim_times``' bf16 call (one
generator seeded SEED + 21 over TIMED_HEAD_DIMS x TIMED_BH, T 512, causal),
then each ``--extra`` shape from a generator seeded SEED + 30 (default
(16384, 512, 64) and (8192, 512, 128): as many elements as (4096, 512,
256)). An element misses where |x - bf16(float64)| exceeds one ulp of the
larger plus 1e-6 (``chip_smoke._bf16_gate``'s test; elements exactly 0 in
float64 are left out). Prints the card's name and power limit, the misses
and the worst ratio of difference to tolerance by shape, output and side,
and the first kernel misses with their values. Exits 1 if a kernel misses.
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _misses(name: str, shape, got, ref, exact, torch, cs) -> int:
    """Prints the kernel's and the twin's misses of one output; returns the
    kernel's."""
    x16 = exact.bfloat16().float()
    zero = exact == 0
    report, kernel_misses = [], 0
    for side, value in (("kernel", got), ("twin", ref)):
        a = value.float()
        tol = cs.BF16_ULP * torch.maximum(a.abs(), x16.abs()) + 1e-6
        excess = torch.where(zero, torch.zeros_like(a), (a - x16).abs() / tol)
        missed = excess > 1
        n = int(missed.sum())
        report.append(f"{side} {n} missed, worst difference / tolerance "
                      f"{excess.max().item():.4f}")
        if side == "kernel":
            kernel_misses = n
            for index in missed.nonzero()[:6].tolist():
                at = tuple(index)
                print(f"  {shape} {name} {at}: kernel {a[at].item():.9g}, twin "
                      f"{ref[at].float().item():.9g}, float64 {exact[at].item():.12g}, tolerance "
                      f"{tol[at].item():.3g}", flush=True)
    print(f"{shape} {name}: {'; '.join(report)}", flush=True)
    return kernel_misses


def main(argv) -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--extra", nargs="*", default=["16384,512,64", "8192,512,128"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_gate_misses: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gordo_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._card(), flush=True)
    t = cs.CONFIG["lookback_window"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
    draws = [((bh, t, dh), g) for dh in cs.TIMED_HEAD_DIMS for bh in cs.TIMED_BH]
    for extra in args.extra:
        draws.append((tuple(int(n) for n in extra.split(",")),
                      torch.Generator(device="cuda").manual_seed(cs.SEED + 30)))
    misses = 0
    for shape, gen in draws:
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).bfloat16()
                       for _ in range(4))
        o, lse = fa.flash_attention_forward(q, k, v, True)
        inputs = (q, k, v, o, lse, do)
        got = dict(zip(("dq", "dk", "dv"), (fa.launch_dq(*inputs, True),
                                            *fa.launch_dkv(*inputs, True))))
        torch.cuda.synchronize()
        parts = max(1, shape[0] // 256)
        refs = cs._plain_in_parts(fa.flash_attention_backward_plain, inputs, True, parts)
        exact = cs._plain_in_parts(fa.flash_attention_backward_plain, inputs, True, parts,
                                   torch.float64)
        for name, ref, ex in zip(("dq", "dk", "dv"), refs, exact):
            misses += _misses(name, shape, got[name], ref, ex, torch, cs)
        del q, k, v, do, o, lse, inputs, got, refs, exact
        torch.cuda.empty_cache()
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
