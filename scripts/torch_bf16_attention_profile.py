"""
Device time of the port's bf16 attention kernels beside PyTorch's fused
``scaled_dot_product_attention`` on the same inputs, from ``torch.profiler``,
on one NVIDIA GPU.

    python3 scripts/torch_bf16_attention_profile.py [ROUNDS]   # from the repo root

CUDA events around a call at the training shape time the host's enqueue as
much as the card (SDPA's backward through autograd most of all); the
profiler's kernel times do not. Compared, on inputs made from
``chip_smoke.SEED``:

- ``backward``, at the training shape (BH 128 x T 512 x dh 64, causal):
  the port's dQ and dK/dV launches against SDPA's backward through
  autograd, the inputs given to SDPA as (1, BH, T, dh), and against the
  kernels' plain twin (``flash_attention_backward_plain``: dQ, dK and dV);
- ``backward_serve``, the same at the serving shape's size (BH 4,096),
  where the launch cost no longer hides the card's time;
- ``forward``, at the serving shape (BH 4,096): the port's forward against
  SDPA's forward.

Each of ROUNDS rounds (default 5) profiles ITERS calls of each side and
takes the device time per call, summed over the kernels the calls launch;
CUDA events time the same calls beside it. Prints the card's name and power
limit, a line per round, each side's kernels with their least and most
device time per call over the rounds, and one JSON line.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ITERS = 50


def device_ms(fn, iters: int) -> tuple:
    """(device ms per call summed over its kernels, {kernel: ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            kernels[event.key[:100]] = event.self_device_time_total / 1e3 / iters
    return sum(kernels.values()), kernels


def main(rounds: int) -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_bf16_attention_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.ops import flash_attention as fa

    card = chip_smoke._card()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)

    def backward_sides(shape):
        """The port's dQ and dK/dV launches, SDPA's backward through
        autograd and the plain twin, on the same inputs of ``shape``."""
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g).bfloat16()
                       for _ in range(4))
        out, lse = fa.flash_attention_forward(q, k, v, True)
        leaves = [x.unsqueeze(0).clone().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        sdpa_grad = do.unsqueeze(0)

        def port_backward():
            fa.launch_dq(q, k, v, out, lse, do, True)
            fa.launch_dkv(q, k, v, out, lse, do, True)

        return {"port": port_backward,
                "sdpa": lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_grad,
                                                    retain_graph=True),
                "plain": lambda: fa.flash_attention_backward_plain(q, k, v, out, lse, do, True)}

    serve = [torch.randn(chip_smoke.SERVE_SHAPE, device="cuda", generator=g).bfloat16()
             for _ in range(3)]
    serve4 = [x.unsqueeze(0) for x in serve]
    sides = {
        "backward": backward_sides(chip_smoke.TRAIN_SHAPE),
        "backward_serve": backward_sides(chip_smoke.SERVE_SHAPE),
        "forward": {
            "port": lambda: fa.flash_attention_forward(*serve, True),
            "sdpa": lambda: F.scaled_dot_product_attention(*serve4, is_causal=True),
        },
    }
    readings = {case: {side: {"device_ms": [], "event_ms": []} for side in fns}
                for case, fns in sides.items()}
    names = {case: {} for case in sides}
    for r in range(rounds):
        for case, fns in sides.items():
            line = []
            for side, fn in fns.items():
                ms, kernels = device_ms(fn, ITERS)
                event = chip_smoke._time_ms(fn, ITERS)
                readings[case][side]["device_ms"].append(ms)
                readings[case][side]["event_ms"].append(event)
                for kernel, kernel_ms in kernels.items():
                    names[case].setdefault(side, {}).setdefault(kernel, []).append(kernel_ms)
                line.append(f"{side} device {ms:.4f} ms (events {event:.4f})")
            print(f"round {r} {case} on {card}: " + ", ".join(line), flush=True)
    for case, by_side in names.items():
        for side, kernels in by_side.items():
            print(f"{case} {side} kernels (ms per call, least and most of the rounds): "
                  + "; ".join(f"{name} {min(ms):.4f}-{max(ms):.4f}"
                              for name, ms in kernels.items()), flush=True)
    summary = {case: {side: {key: [min(x), max(x)] for key, x in r.items()}
                      for side, r in by_side.items()} for case, by_side in readings.items()}
    print(json.dumps({"card": card, "iters": ITERS, "rounds": rounds,
                      "train_shape": list(chip_smoke.TRAIN_SHAPE),
                      "serve_shape": list(chip_smoke.SERVE_SHAPE),
                      "min_max": summary, "readings": readings, "kernels": names}))
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 5))
