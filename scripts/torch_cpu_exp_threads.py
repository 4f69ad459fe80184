"""
How often torch's CPU ``exp`` comes out inaccurate in a fresh process on a
loaded machine, with two intra-op threads and with one.

    python3 scripts/torch_cpu_exp_threads.py [RUNS]     # from the repo root

Starts eight busy processes (float32 matmuls), then RUNS fresh probe
processes for each thread count. A probe computes ``torch.exp(s - max)``
over seeded (4, 512, 512) attention scores, causal, as the plain twin of
the flash forward does, and reports the largest error relative to float64
and how many entries are off by more than 1e-6. Prints one JSON line.
"""

import json
import subprocess
import sys
import time

PROBE = r"""
import sys, numpy as np, torch
torch.set_num_threads(int(sys.argv[1]))
rng = np.random.RandomState(0)
q, k = (torch.from_numpy(rng.randn(4, 512, 64).astype(np.float32)) for _ in range(2))
s = (q @ k.transpose(-1, -2)) / 8.0
s = s.masked_fill(~torch.ones(512, 512, dtype=torch.bool).tril(), -1e30)
x = s - s.amax(dim=-1, keepdim=True)
p, p64 = torch.exp(x), torch.exp(x.double())
live = p64 > 1e-30
rel = ((p.double() - p64).abs() / p64.clamp_min(1e-30))[live]
print(f"{rel.max().item()} {int((rel > 1e-6).sum())}")
"""
LOAD = r"""
import time, torch
a = torch.randn(1024, 1024)
t0 = time.time()
while time.time() - t0 < float(__import__("sys").argv[1]):
    a = torch.tanh(a @ a)
"""


def main() -> int:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    load = [subprocess.Popen([sys.executable, "-c", LOAD, str(30 + 8 * runs)])
            for _ in range(8)]
    time.sleep(3)
    report = {}
    try:
        for threads in (2, 1):
            errors = []
            for _ in range(runs):
                out = subprocess.run([sys.executable, "-c", PROBE, str(threads)],
                                     capture_output=True, text=True, check=True).stdout.split()
                errors.append((float(out[0]), int(out[1])))
            bad = [e for e in errors if e[1]]
            report[f"threads_{threads}"] = {
                "runs": runs, "runs_off": len(bad),
                "worst_rel_err": max(e[0] for e in errors),
                "entries_off_in_worst_run": max((e[1] for e in bad), default=0)}
            print(threads, report[f"threads_{threads}"], flush=True)
    finally:
        for proc in load:
            proc.kill()
            proc.wait()
    print(json.dumps({"torch_cpu_exp": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
