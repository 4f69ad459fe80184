"""
The bf16 flash-attention kernels against variants of their sources, on one
NVIDIA GPU.

    python3 scripts/torch_bf16_variants.py [VARIANT ...]   # from the repo root

A variant is the kernels' sources (``gordo_tpu_torch/ops/csrc``) with a
few text replacements (``VARIANTS``: each names its file;
``tests/test_torch_build.py`` checks on the CPU that each applies). Three
kinds:

- accumulation choices, held to the gates: how deep each product's wgmma
  chain runs in one accumulator before it is added in float32, the
  alternatives to the sources' choices: in the forward
  (``flash_attention_bf16.cu``) P V a tile at a time instead of over the
  whole loop; in dK/dV (``flash_attention_bwd_bf16.cu``) S^T and dP^T one
  k16 step at a time instead of a tile, P^T dO a tile at a time instead of
  the whole loop, dS^T Q the whole loop instead of a tile; in dQ (the same
  file) S and dP one k16 step at a time instead of a tile, dS K a tile at
  a time instead of the whole loop, dS in two bf16 parts or one instead of
  three, and D = rowsum(dO O) by float32 fmas on the CUDA cores instead of
  the diagonal of dO O^T on the tensor cores;
- layouts and schedules: in the forward two consumer warpgroups (128-row
  work tiles) instead of three at dh 64, 128-key K/V tiles, a ring of K/V
  stages 4 or 5 deep instead of 3, O rescaled whenever a row's max grows
  instead of only when it grows by more than 2^8; in dQ S and dP waited
  for apart, a ring 2 or 4 deep instead of 3, one block per work instead
  of a persistent block per SM;
- diagnostic cuts (``DIAGNOSTIC``), timed only, their results wrong by
  design: a part of the work taken out to see what it costs, or every
  head reading head 0's K and V (which then stay in L2).

Each variant's copy of the bf16 sources is compiled into
``build/bf16_variants/<name>/`` with the port's nvcc flags, all at once;
its forward, dQ and dK/dV then take the place of the wrappers' kernels.
For the source's kernels and each accumulation variant, over SEEDS inputs
at the training shape (BH 128 x T 512 x dh 64, causal): the elements of
out, dq, dk and dv outside ``chip_smoke.py``'s one-ulp gate against the
plain twin (elements exactly 0 in float64 held to |x| <= 1e-6), the share
that differ from the twin at all, the largest error against the float64
plain result relative to its largest entry (the twin's own beside it).
For every variant, the times at the serving and training shapes, and of
the forward at the serving shape's size with dh 128 (BH 2,048 x T 512),
in ROUNDS alternating turns with the source's kernels (source, variant,
source, variant, ...; CALLS calls a turn), each side's median turn, or the
error of a variant that cannot launch there. Prints the
card's name and power limit, each variant's ptxas warnings and spills, a
line per variant and one JSON line.
"""

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gordo_tpu_torch" / "ops" / "csrc"
OUT = REPO / "build" / "bf16_variants"
SEEDS = 4
ROUNDS = 5  # timed turns of each side
CALLS = 50  # calls a turn
SOURCES = ("flash_attention_bf16", "flash_attention_bwd_bf16")
FWD = "flash_attention_bf16.cu"
BWD = "flash_attention_bwd_bf16.cu"

# name -> [(file in csrc, its text, the replacement)]; each text must occur once
VARIANTS = {
    "fwd_pv_tile": [(FWD, """    int pending = 0;                      // the stage of the pending tile
""", """    int pending = 0;                      // the stage of the pending tile
    float f[DH / 2];                      // P V of the pending tile
"""), (FWD, """      if (__any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < DH / 2; i += 4) {
          o[i] *= corr0;
          o[i + 1] *= corr0;
          o[i + 2] *= corr1;
          o[i + 3] *= corr1;
        }
      }
      fence_regs(o);
      wgmma_fence();
      rs_product<DH, NC>(o, a, v_desc, true);
""", """      fence_regs(f);
      wgmma_fence();
      rs_product<DH, NC>(f, a, v_desc, false);
"""), (FWD, """      fence_regs(o);
      fence_split(a);
""", """      fence_regs(f);
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        o[i] = fmaf(o[i], corr0, f[i]);
        o[i + 1] = fmaf(o[i + 1], corr0, f[i + 1]);
        o[i + 2] = fmaf(o[i + 2], corr1, f[i + 2]);
        o[i + 3] = fmaf(o[i + 3], corr1, f[i + 3]);
      }
      fence_split(a);
""")],
    "dkv_st_step": [(BWD, """      fence_regs(sa);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) Wgmma<BQ>::ss(sa, ka(kk), qb(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) Wgmma<BQ>::ss(dp, va(kk), gb(kk), kk > 0);
      wgmma_commit();
""", """#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        float fs[BQ / 2], fd[BQ / 2];
        fence_regs(fs);
        fence_regs(fd);
        wgmma_fence();
        Wgmma<BQ>::ss(fs, ka(kk), qb(kk), 0);
        Wgmma<BQ>::ss(fd, va(kk), gb(kk), 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(fs);
        fence_regs(fd);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          sa[i] = kk == 0 ? fs[i] : sa[i] + fs[i];
          dp[i] = kk == 0 ? fd[i] : dp[i] + fd[i];
        }
      }
""")],
    "dkv_dv_tile": [(BWD, """      fence_regs(dva);
      wgmma_fence();
      rs_product<DH, NC>(dva, pa, gmn, true);
      wgmma_commit();
""", """      {
        float f[DH / 2];
        rs_fresh<DH, NC>(f, pa, gmn);
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) dva[i] += f[i];
      }
""")],
    "dkv_dk_loop": [(BWD, """      {
        float f[DH / 2];
        rs_fresh<DH, NC>(f, da, qmn);
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) dka[i] += f[i];
      }
""", """      fence_regs(dka);
      wgmma_fence();
      rs_product<DH, NC>(dka, da, qmn, true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
""")],
    "dq_sdp_step": [(BWD, """      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        Wgmma<BN>::ss(sc, L::k_major(q_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(k_tile, BN, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        Wgmma<BN>::ss(dp, L::k_major(do_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(v_tile, BN, 0, kk), kk > 0);
      }
      wgmma_commit();
""", """#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        float fs[BN / 2], fd[BN / 2];
        fence_regs(fs);
        fence_regs(fd);
        wgmma_fence();
        Wgmma<BN>::ss(fs, L::k_major(q_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(k_tile, BN, 0, kk), 0);
        Wgmma<BN>::ss(fd, L::k_major(do_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(v_tile, BN, 0, kk), 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(fs);
        fence_regs(fd);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          sc[i] = kk == 0 ? fs[i] : sc[i] + fs[i];
          dp[i] = kk == 0 ? fd[i] : dp[i] + fd[i];
        }
      }
""")],
    "dq_tile": [(BWD, """    int pending = 0;        // the stage of the pending tile
""", """    int pending = 0;        // the stage of the pending tile
    float f[DH / 2];        // dS K of the pending tile
"""), (BWD, """      fence_regs(acc);
      wgmma_fence();
      rs_product<DH, NC>(acc, a, k_desc, true);
""", """      fence_regs(f);
      wgmma_fence();
      rs_product<DH, NC>(f, a, k_desc, false);
"""), (BWD, """      fence_regs(acc);
      fence_split(a);
""", """      fence_regs(f);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] += f[i];
      fence_split(a);
""")],
    "dq_two_parts": [(BWD, "      rs_product<DH, NC>(acc, a, k_desc, true);\n", """#pragma unroll
      for (int part = 1; part < 3; ++part) {
#pragma unroll
        for (int c = 0; c < NC; ++c) Wgmma<DH>::rs(acc, a[c][part], k_desc(c), 1);
      }
""")],
    "dq_one_part": [(BWD, "      rs_product<DH, NC>(acc, a, k_desc, true);\n", """#pragma unroll
      for (int c = 0; c < NC; ++c) Wgmma<DH>::rs(acc, a[c][2], k_desc(c), 1);
""")],
    # dQ's D = rowsum(dO O) by float32 fmas on the CUDA cores, from the
    # shared O and dO tiles, instead of the diagonal of dO O^T on the tensor
    # cores
    "dq_d_fma": [(BWD, """        const uint32_t o_tile = (wg == 0 ? k_slot : v_slot) + s * C::KV_BYTES;
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          Wgmma<BN>::ss(dp, L::k_major(do_tile, BLOCK_M, 64 * wg, kk),
                        L::k_major(o_tile, BN, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dp);
        // (r, r), r = 16 warp + g + 8 h, is column g of column group
        // 2 warp + h, held by lane 4 g + g / 2 of the quad
        float diag0 = 0.f, diag1 = 0.f;
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          if (w4 == warp) {
            diag0 = (g & 1) ? dp[8 * w4 + 1] : dp[8 * w4];
            diag1 = (g & 1) ? dp[8 * w4 + 7] : dp[8 * w4 + 6];
          }
        }
        d0 = __shfl_sync(0xffffffffu, diag0, 4 * g + g / 2);
        d1 = __shfl_sync(0xffffffffu, diag1, 4 * g + g / 2);
""", """        const uint8_t* o_rows = smem + (wg == 0 ? C::K : C::V) + s * C::KV_BYTES;
        const uint8_t* do_rows = smem + C::Q + b * 2 * C::Q_BYTES + C::Q_BYTES;
        const int r = 16 * warp + g;
        float part0 = 0.f, part1 = 0.f;
#pragma unroll
        for (int ch = tq; ch < DH / 8; ch += 4) {
          part0 = dot8(*reinterpret_cast<const uint4*>(o_rows + L::offset(BN, r, 8 * ch)),
                       *reinterpret_cast<const uint4*>(
                           do_rows + L::offset(BLOCK_M, 64 * wg + r, 8 * ch)), part0);
          part1 = dot8(*reinterpret_cast<const uint4*>(o_rows + L::offset(BN, r + 8, 8 * ch)),
                       *reinterpret_cast<const uint4*>(
                           do_rows + L::offset(BLOCK_M, 64 * wg + r + 8, 8 * ch)), part1);
        }
        d0 = quad_sum(part0);
        d1 = quad_sum(part1);
""")],
    # dQ's schedule: S and dP in two commit groups, P computed while dP
    # runs; K/V rings of 2 or 4 stages instead of 3 (4 does not fit at
    # dh 128); one block per work instead of a persistent block per SM
    "dq_split_wait": [(BWD, """                      L::k_major(k_tile, BN, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        Wgmma<BN>::ss(dp,""", """                      L::k_major(k_tile, BN, 0, kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        Wgmma<BN>::ss(dp,"""), (BWD, """      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      if (kt == mine - 1) mbar_arrive_warp(&q_empty[b]);  // the last read of Q and dO
      probabilities(kt);
      score_grads();
""", """      wgmma_wait<2>();
      fence_regs(sc);
      probabilities(kt);
      wgmma_wait<1>();
      fence_regs(dp);
      if (kt == mine - 1) mbar_arrive_warp(&q_empty[b]);  // the last read of Q and dO
      score_grads();
"""), (BWD, """      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (mine == 1) mbar_arrive_warp(&q_empty[b]);
      probabilities(0);
      score_grads();
""", """      wgmma_wait<1>();
      fence_regs(sc);
      probabilities(0);
      wgmma_wait<0>();
      fence_regs(dp);
      if (mine == 1) mbar_arrive_warp(&q_empty[b]);
      score_grads();
""")],
    "dq_stages2": [(BWD, "  static constexpr int STAGES = 3;", "  static constexpr int STAGES = 2;")],
    "dq_stages4": [(BWD, "  static constexpr int STAGES = 3;", "  static constexpr int STAGES = 4;")],
    "dq_grid": [(BWD, "  const unsigned grid = static_cast<unsigned>(n_work < sms ? n_work : sms);",
                 "  const unsigned grid = static_cast<unsigned>(n_work);")],
    # the forward's layout: two consumer warpgroups (128-row work tiles)
    # instead of three at dh 64; 128-key tiles; a deeper ring of K/V stages
    "fwd_2wg": [(FWD, "static constexpr int CONSUMERS = DH == 128 ? 2 : 3;",
                 "static constexpr int CONSUMERS = 2;")],
    "fwd_bn128": [(FWD, "static constexpr int BN = 64;", "static constexpr int BN = 128;")],
    "fwd_stages4": [(FWD, "  static constexpr int STAGES = 3;", "  static constexpr int STAGES = 4;")],
    "fwd_stages5": [(FWD, "  static constexpr int STAGES = 3;", "  static constexpr int STAGES = 5;")],
    # the softmax: O and l rescaled whenever a row's max grows at all
    "fwd_rescale_every_growth": [(FWD, "constexpr float RESCALE = 8.f;",
                                  "constexpr float RESCALE = 0.f;")],
    # a warp barrier before the wait for P V, against ptxas hoisting the wait
    # above the softmax's exponentials
    "fwd_syncwarp": [(FWD, """      softmax(kt);
      wgmma_wait<0>();
""", """      softmax(kt);
      __syncwarp();
      wgmma_wait<0>();
""")],
    # diagnostic cuts
    "fwd_kv_head0": [(FWD, "&k_map, &full[s], p * L::COLS, kt * BN, bh);",
                      "&k_map, &full[s], p * L::COLS, kt * BN, 0);"),
                     (FWD, "&v_map, &full[s], p * L::COLS, kt * BN, bh);",
                      "&v_map, &full[s], p * L::COLS, kt * BN, 0);")],
    "no_split": [("wgmma_bf16.cuh", """  hi = pack_high(x0, x1);
  const float r0 = x0 - truncate_bf16(x0), r1 = x1 - truncate_bf16(x1);
  mid = pack_high(r0, r1);
  lo = pack_high(r0 - truncate_bf16(r0), r1 - truncate_bf16(r1));""",
                  "  hi = mid = lo = pack_high(x0, x1);")],
    "fwd_no_pv": [(FWD, "      rs_product<DH, NC>(o, a, v_desc, true);\n", "")],
    "fwd_no_s": [(FWD, """        Wgmma<BN>::ss(sc, L::k_major(q_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(k_tile, BN, 0, kk), kk > 0);
""", "")],
}
DIAGNOSTIC = {"no_split", "fwd_no_pv", "fwd_no_s", "fwd_kv_head0"}


def _build(name: str, patches, csrc: Path = CSRC) -> dict:
    """Compile the bf16 sources of ``csrc`` with the patches applied;
    returns ``{source stem: library path}``."""
    from gordo_tpu_torch.ops import _build

    out = OUT / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for path in [*csrc.glob("*.cuh"), *(csrc / f"{stem}.cu" for stem in SOURCES)]:
        (out / path.name).write_text(path.read_text())
    for file, old, new in patches:
        text = (out / file).read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: a patch does not apply to {file}")
        (out / file).write_text(text.replace(old, new))
    libs = {}
    for stem in SOURCES:
        libs[stem] = out / f"lib{stem}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(libs[stem]),
                               str(out / f"{stem}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed on {stem}.cu\n{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Performance Loss" in line or ("spill stores" in line
                                              and not line.strip().startswith("0 bytes")
                                              and " 0 bytes spill stores" not in line):
                print(f"{name} {stem}: {line.strip()[:160]}", flush=True)
    return libs


def _kernels(libs: dict) -> dict:
    """The variant's C functions, typed as the wrappers' own."""
    from gordo_tpu_torch.ops import flash_attention as fa

    kernels = {}
    for key, stem, symbol, like in (
            ("forward", "flash_attention_bf16", "gordo_flash_attention_forward_bf16",
             fa._bf16_kernel),
            ("dq", "flash_attention_bwd_bf16", "gordo_flash_attention_backward_dq_bf16",
             fa._bf16_dq_kernel),
            ("dkv", "flash_attention_bwd_bf16", "gordo_flash_attention_backward_dkv_bf16",
             fa._bf16_dkv_kernel)):
        fn = getattr(ctypes.CDLL(str(libs[stem])), symbol)
        fn.argtypes, fn.restype = like().argtypes, ctypes.c_int
        kernels[key] = fn
    return kernels


def _use(kernels: dict) -> None:
    from gordo_tpu_torch.ops import flash_attention as fa

    fa._bf16_kernel = lambda: kernels["forward"]
    fa._bf16_dq_kernel = lambda: kernels["dq"]
    fa._bf16_dkv_kernel = lambda: kernels["dkv"]


def _errors(got, ref, exact) -> tuple:
    """(elements outside the one-ulp gate, share that differ, error
    against float64 relative to its largest entry)."""
    import torch

    a, b = got.float(), ref.float()
    zero = exact == 0
    ok = (a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6
    ok = torch.where(zero, a.abs() <= 1e-6, ok)
    share = ((a != b) & ~zero).float().mean().item()
    f64 = ((got.double() - exact).abs().max() / exact.abs().max().clamp_min(1.0)).item()
    return int((~ok).sum()), share, f64


def main(names) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bf16_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.ops import flash_attention as fa

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["source"] + (names or list(VARIANTS))
    patches = {"source": [], **VARIANTS}
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: _build(n, patches[n]), names)))
    kernels = {name: _kernels(libs) for name, libs in built.items()}

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    cases = []
    for _ in range(SEEDS):
        q, k, v, do = (torch.randn(chip_smoke.TRAIN_SHAPE, device="cuda", generator=g).bfloat16()
                       for _ in range(4))
        cases.append((q, k, v, do))
    report = {}
    for name in names:
        report[name] = {}
        if name in DIAGNOSTIC:
            continue
        _use(kernels[name])
        stats = {key: [0, 0.0, 0.0, 0.0] for key in ("out", "dq", "dk", "dv")}
        for q, k, v, do in cases:
            out, lse = fa.flash_attention_forward(q, k, v, True)
            grads = fa.flash_attention_backward(q, k, v, out, lse, do, True)
            ref_out, _ = fa.flash_attention_forward_plain(q, k, v, True)
            exact_out, _ = fa.flash_attention_forward_plain(*(x.double() for x in (q, k, v)), True)
            refs = fa.flash_attention_backward_plain(q, k, v, out, lse, do, True)
            exact = fa.flash_attention_backward_plain(
                *(x.double() for x in (q, k, v, out, lse, do)), True)
            for key, got, ref, ref64 in zip(stats, (out, *grads), (ref_out, *refs),
                                            (exact_out, *exact)):
                bad, share, f64 = _errors(got, ref, ref64)
                plain64 = _errors(ref, ref, ref64)[2]
                s = stats[key]
                stats[key] = [s[0] + bad, max(s[1], share), max(s[2], f64), max(s[3], plain64)]
        report[name] = {key: dict(zip(("outside_gate", "share_differing", "f64_rel_err",
                                       "plain_f64_rel_err"), s)) for key, s in stats.items()}
        print(f"{name}: " + "; ".join(
            f"{key} {s[0]} outside the gate, share {s[1]:.2e}, vs float64 {s[2]:.2e} "
            f"(plain {s[3]:.2e})" for key, s in stats.items()), flush=True)

    serve = [torch.randn(chip_smoke.SERVE_SHAPE, device="cuda", generator=g).bfloat16()
             for _ in range(3)]
    bh, t, dh = chip_smoke.SERVE_SHAPE
    wide = [torch.randn((bh * dh // 128, t, 128), device="cuda", generator=g).bfloat16()
            for _ in range(3)]
    q, k, v, do = cases[0]
    out, lse = fa.flash_attention_forward(q, k, v, True)
    timers = {
        "forward_serving": lambda: fa.flash_attention_forward(*serve, True),
        "forward_dh128": lambda: fa.flash_attention_forward(*wide, True),
        "forward": lambda: fa.flash_attention_forward(q, k, v, True),
        "dq": lambda: fa.launch_dq(q, k, v, out, lse, do, True),
        "dkv": lambda: fa.launch_dkv(q, k, v, out, lse, do, True),
    }
    for name in names[1:]:
        times = {}
        for key, fn in timers.items():
            turns = {"source": [], "variant": []}
            try:
                for _ in range(ROUNDS):
                    for side, turn in (("source", "source"), ("variant", name)):
                        _use(kernels[turn])
                        turns[side].append(chip_smoke._time_ms(fn, CALLS))
            except RuntimeError as exc:  # a variant that cannot launch at this shape
                times[key] = {"error": str(exc)}
                continue
            times[key] = {"source_ms": statistics.median(turns["source"]),
                          "variant_ms": statistics.median(turns["variant"]), "turns": turns}
        report[name]["times"] = times
        print(f"{name} on {card}: " + ", ".join(
            f"{key} {t['variant_ms']:.4f} ms (source {t['source_ms']:.4f})" if "error" not in t
            else f"{key} {t['error']}" for key, t in times.items()), flush=True)
    print(json.dumps({"card": card, "shape": list(chip_smoke.TRAIN_SHAPE), "seeds": SEEDS,
                      "variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
