"""
Time variants of the flash-attention dQ kernel against the one in
``gordo_tpu_torch/ops/csrc/flash_attention_bwd.cu``, on one NVIDIA GPU.

    python3 scripts/torch_dq_variants.py [VARIANT ...]   # from the repo root

A variant is the kernel source with a few text replacements (``PATCHES``
and ``VARIANTS`` below); each is written to ``build/dq_variants/`` and
compiled with the port's nvcc flags, all at once, then loaded with ctypes
and put in the place of the dQ wrapper's kernel. For the source's own
kernel and each variant: registers and spills at dh 64, HMMA instructions,
shared memory and blocks per SM at dh 64; errors against the plain backward
at ``chip_smoke.py``'s backward shapes, and bit-identical reruns; the time
at the training shape (BH 128 x T 512 x dh 64, causal) in turns with the
source's kernel (source, variant, variant, source); and ``chip_smoke.py``'s
one-step gradient and 20-step loss errors through it. Prints the card's name
and power limit, a line per variant and one JSON line. ``HEADER_PATCHES``
change mma_tf32x3.cuh in the variant's own copy.
"""

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "gordo_tpu_torch" / "ops" / "csrc" / "flash_attention_bwd.cu"
HEADER = SOURCE.parent / "mma_tf32x3.cuh"
OUT = REPO / "build" / "dq_variants"

# name -> [(text of the source, its replacement)]; each text must occur
# once. Patches of HEADER_PATCHES apply to mma_tf32x3.cuh (and so to every
# kernel of the variant's library; only its dQ kernel is measured).
HEADER_PATCHES = {
    # small = x - big rounded to nearest TF32, not read by the tensor core's
    # truncation
    "small_rn": [("  small = __float_as_uint(x - __uint_as_float(big));",
                  "  small = to_tf32(x - __uint_as_float(big));")],
    # the fourth product, small * small, kept
    "four_terms": [("""  mma_tf32_fresh(p, a[0].small, b[0].big);
  mma_tf32(p, a[0].big, b[0].small);
#pragma unroll
  for (int i = 1; i < N; ++i) {""", """  mma_tf32_fresh(p, a[0].small, b[0].small);
  mma_tf32(p, a[0].small, b[0].big);
  mma_tf32(p, a[0].big, b[0].small);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    mma_tf32(p, a[i].small, b[i].small);""")],
    # the small terms and the big * big terms in two fresh accumulators,
    # two shorter chains of dependent mma instructions
    "two_chains": [("""  mma_tf32_fresh(p, a[0].small, b[0].big);
  mma_tf32(p, a[0].big, b[0].small);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    mma_tf32(p, a[i].small, b[i].big);
    mma_tf32(p, a[i].big, b[i].small);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(p, a[i].big, b[i].big);
  d[0] += p[0];
  d[1] += p[1];
  d[2] += p[2];
  d[3] += p[3];""", """  mma_tf32_fresh(p, a[0].small, b[0].big);
  mma_tf32(p, a[0].big, b[0].small);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    mma_tf32(p, a[i].small, b[i].big);
    mma_tf32(p, a[i].big, b[i].small);
  }
  float q[4];
  mma_tf32_fresh(q, a[0].big, b[0].big);
#pragma unroll
  for (int i = 1; i < N; ++i) mma_tf32(q, a[i].big, b[i].big);
  d[0] += q[0] + p[0];
  d[1] += q[1] + p[1];
  d[2] += q[2] + p[2];
  d[3] += q[3] + p[3];""")],
}
# the source's S and dP loop, and its dQ product
FUSED_S_DP = """#pragma unroll 2
    for (int kk = 0; kk < DH / 8; kk += 2) {
      const FragA aq[2] = {load_a(qw + 8 * kk, LD, g, tq), load_a(qw + 8 * kk + 8, LD, g, tq)};
      const FragA ag[2] = {load_a(gw + 8 * kk, LD, g, tq), load_a(gw + 8 * kk + 8, LD, g, tq)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kn = ks + 8 * n * LD + 8 * kk;
        const float* vn = vs + 8 * n * LD + 8 * kk;
        const FragB bk[2] = {load_b_nk(kn, LD, g, tq), load_b_nk(kn + 8, LD, g, tq)};
        const FragB bv[2] = {load_b_nk(vn, LD, g, tq), load_b_nk(vn + 8, LD, g, tq)};
        mma_3xtf32_sum<2>(s[n], aq, bk);
        mma_3xtf32_sum<2>(ds[n], ag, bv);
      }
    }"""
DQ_PRODUCT = "    product_nn<DH>(acc, ds, ks, g, tq);  // dQ += dS K (times scale below)"
# fragment loads from operands split into TF32 big and small parts in shared
# memory, the small part SMALL floats past the big one
PRESPLIT_LOADS = """
template <int SMALL>
__device__ __forceinline__ FragA load_a_pre(const float* s, int ld, int g, int t) {
  const int off[4] = {g * ld + t, (g + 8) * ld + t, g * ld + t + 4, (g + 8) * ld + t + 4};
  FragA f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    f.big[r] = __float_as_uint(s[off[r]]);
    f.small[r] = __float_as_uint(s[SMALL + off[r]]);
  }
  return f;
}

template <int SMALL>
__device__ __forceinline__ FragB load_b_pre(const float* s, int off0, int off1) {
  FragB f;
  f.big[0] = __float_as_uint(s[off0]);
  f.big[1] = __float_as_uint(s[off1]);
  f.small[0] = __float_as_uint(s[SMALL + off0]);
  f.small[1] = __float_as_uint(s[SMALL + off1]);
  return f;
}
"""
PATCHES = {
    # S = Q K^T and dP = dO V^T as two loops, one after the other
    "separate_s_dp": [(FUSED_S_DP, """    product_nt<DH>(s, qw, ks, g, tq);   // S = Q K^T
    product_nt<DH>(ds, gw, vs, g, tq);  // dP = dO V^T""")],
    # dQ += dS K in one fresh sum per 8 keys, as the forward's O
    "per_8_keys": [(DQ_PRODUCT, """#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const FragA a = acc_to_a(ds[n]);
#pragma unroll
      for (int m = 0; m < OT; ++m) {
        mma_3xtf32(acc[m], a, load_b_kn_paired(ks + 8 * n * LD + 8 * m, LD, g, tq));
      }
    }""")],
    # Q and dO split into TF32 big and small parts once per block, in
    # shared memory, and their A fragments loaded as they are
    "presplit_qdo": [
        ("// --- dQ ---\n", "// --- dQ ---\n" + PRESPLIT_LOADS),
        ("  static constexpr int KV = 2 * TILE * LD;  // [stage][K, V][BK][LD]",
         "  static constexpr int KV = 4 * TILE * LD;  // after Q, dO, their small parts"),
        ("""    __syncthreads();
    if (kt + 1 < n_k_tiles) {""", """    __syncthreads();
    if (kt == 0) {
      for (int i = threadIdx.x; i < 2 * TILE * LD; i += THREADS) {
        uint32_t big, small;
        split(smem[C::Q + i], big, small);
        smem[C::Q + i] = __uint_as_float(big);
        smem[C::Q + 2 * TILE * LD + i] = __uint_as_float(small);
      }
      __syncthreads();
    }
    if (kt + 1 < n_k_tiles) {"""),
        ("""      const FragA aq[2] = {load_a(qw + 8 * kk, LD, g, tq), load_a(qw + 8 * kk + 8, LD, g, tq)};
      const FragA ag[2] = {load_a(gw + 8 * kk, LD, g, tq), load_a(gw + 8 * kk + 8, LD, g, tq)};""",
         """      constexpr int SQ = 2 * TILE * LD;
      const FragA aq[2] = {load_a_pre<SQ>(qw + 8 * kk, LD, g, tq),
                           load_a_pre<SQ>(qw + 8 * kk + 8, LD, g, tq)};
      const FragA ag[2] = {load_a_pre<SQ>(gw + 8 * kk, LD, g, tq),
                           load_a_pre<SQ>(gw + 8 * kk + 8, LD, g, tq)};"""),
    ],
    # each K/V tile split into TF32 big and small parts once per stage
    "presplit_kv": [
        ("// --- dQ ---\n", "// --- dQ ---\n" + PRESPLIT_LOADS),
        ("  static constexpr int SMEM_FLOATS = KV + 4 * BK * LD;\n};",
         "  static constexpr int SMEM_FLOATS = KV + 8 * BK * LD;\n};"),
        ("      float* next = smem + C::KV + (stage ^ 1) * 2 * BK * LD;",
         "      float* next = smem + C::KV + (stage ^ 1) * 4 * BK * LD;"),
        ("    const float* ks = smem + C::KV + stage * 2 * BK * LD;",
         "    const float* ks = smem + C::KV + stage * 4 * BK * LD;"),
        ("    const float* vs = ks + BK * LD;\n    const int k0 = kt * BK;",
         """    const float* vs = ks + BK * LD;
    {
      float* kv = smem + C::KV + stage * 4 * BK * LD;
      for (int i = threadIdx.x; i < 2 * BK * LD; i += THREADS) {
        uint32_t big, small;
        split(kv[i], big, small);
        kv[i] = __uint_as_float(big);
        kv[2 * BK * LD + i] = __uint_as_float(small);
      }
      __syncthreads();
    }
    const int k0 = kt * BK;"""),
        ("""        const FragB bk[2] = {load_b_nk(kn, LD, g, tq), load_b_nk(kn + 8, LD, g, tq)};
        const FragB bv[2] = {load_b_nk(vn, LD, g, tq), load_b_nk(vn + 8, LD, g, tq)};""",
         """        constexpr int SK = 2 * BK * LD;
        const int o0 = g * LD + tq, o1 = g * LD + tq + 4;
        const FragB bk[2] = {load_b_pre<SK>(kn, o0, o1), load_b_pre<SK>(kn + 8, o0, o1)};
        const FragB bv[2] = {load_b_pre<SK>(vn, o0, o1), load_b_pre<SK>(vn + 8, o0, o1)};"""),
        (DQ_PRODUCT, """    {
      FragA a[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) a[n] = acc_to_a(ds[n]);
#pragma unroll
      for (int m = 0; m < OT; ++m) {
        FragB b[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          b[n] = load_b_pre<2 * BK * LD>(ks + 8 * n * LD + 8 * m, 2 * tq * LD + g,
                                         (2 * tq + 1) * LD + g);
        }
        mma_3xtf32_sum<NT>(acc[m], a, b);
      }
    }"""),
    ],
    # the S and dP loop unrolled in full: more chains in flight, more registers
    "unroll_kk": [("""#pragma unroll 2
    for (int kk = 0; kk < DH / 8; kk += 2) {
      const FragA aq[2]""", """#pragma unroll
    for (int kk = 0; kk < DH / 8; kk += 2) {
      const FragA aq[2]""")],
    # three resident blocks per SM asked of the register allocator at dh 64
    "min_blocks_3": [("""template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(""", """template <int DH>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 3 : 1)
flash_bwd_dq_f32(""")],
    # four resident blocks per SM asked of the register allocator at dh 64
    "min_blocks_4": [("""template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(""", """template <int DH>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 4 : 1)
flash_bwd_dq_f32(""")],
    "bk16": [("  static constexpr int BK = DH == 128 ? 16 : 32;",
              "  static constexpr int BK = 16;")],
    "bk64": [("  static constexpr int BK = DH == 128 ? 16 : 32;",
              "  static constexpr int BK = DH == 128 ? 16 : 64;")],
}
VARIANTS = {
    "separate_s_dp": ["separate_s_dp"],
    "separate_s_dp_per_8_keys": ["separate_s_dp", "per_8_keys"],
    "per_8_keys": ["per_8_keys"],
    "presplit_qdo": ["presplit_qdo"],
    "presplit_kv": ["presplit_kv"],
    "presplit_kv_bk16": ["presplit_kv", "bk16"],
    "bk16": ["bk16"],
    "bk16_min_blocks_4": ["bk16", "min_blocks_4"],
    "bk64": ["bk64"],
    "two_chains": ["two_chains"],
    "unroll_kk": ["unroll_kk"],
    "unroll_kk_min_blocks_3": ["unroll_kk", "min_blocks_3"],
    "small_rn": ["small_rn"],
    "four_terms": ["four_terms"],
}


def _patched(text: str, names, patches: dict) -> str:
    for name in names:
        for old, new in patches.get(name, ()):
            # a patch that no longer applies fails loudly, not silently
            if text.count(old) != 1:
                raise ValueError(f"patch {name}: {old.splitlines()[0]!r} occurs "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
    return text


def variant_source(names):
    """The variant's (kernel source, header) texts."""
    unknown = set(names) - set(PATCHES) - set(HEADER_PATCHES)
    if unknown:
        raise ValueError(f"no patch named {sorted(unknown)}")
    return (_patched(SOURCE.read_text(), names, PATCHES),
            _patched(HEADER.read_text(), names, HEADER_PATCHES))


def _compile(name: str, texts):
    from gordo_tpu_torch.ops import _build

    folder = OUT / name
    folder.mkdir(parents=True, exist_ok=True)
    src, lib = folder / SOURCE.name, folder / f"lib{name}.so"
    src.write_text(texts[0])
    (folder / HEADER.name).write_text(texts[1])
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def _dq_registers(log: str) -> str:
    """Registers and spills of the dh-64 dQ kernel from ptxas's report."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "entry function" in line and "flash_bwd_dq_f32ILi64E" in line:
            spill = next(x for x in lines[i + 1:] if "spill" in x).strip()
            used = next(x for x in lines[i + 1:] if "registers" in x)
            return f"{used.split('Used')[1].split(',')[0].strip()}; {spill}"
    return "not reported"


def _functions(lib: Path):
    from gordo_tpu_torch.ops import flash_attention as fa

    handle = ctypes.CDLL(str(lib))
    dq = handle.gordo_flash_attention_backward_dq_f32
    dq.argtypes = fa._dq_kernel().argtypes
    dq.restype = ctypes.c_int
    occ = handle.gordo_flash_attention_backward_dq_f32_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    occ.restype = ctypes.c_int
    return dq, occ


def main(names) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_dq_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.ops import flash_attention as fa

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    names = names or list(VARIANTS)
    texts = {"source": variant_source([]), **{n: variant_source(VARIANTS[n]) for n in names}}
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda n: _compile(n, texts[n]), texts)))
    kernels = {name: _functions(lib) for name, (lib, _) in built.items()}
    base_fn = kernels["source"][0]

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
    cases = []
    for shape, causal in chip_smoke.BACKWARD_SHAPES:
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        o, lse = fa.flash_attention_forward(q, k, v, causal)
        ref = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal)[0]
        cases.append(((q, k, v, o, lse, do, causal), ref))
    q, k, v, do = (torch.randn(chip_smoke.TRAIN_SHAPE, device="cuda", generator=g)
                   for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    rng = np.random.RandomState(chip_smoke.SEED)
    rows = np.concatenate([chip_smoke._series(4096, 0, rng), chip_smoke._series(2048, 4096, rng)])
    spec = TransformerAutoEncoder(**chip_smoke.CONFIG).build_spec(8, 8)

    def use(fn):
        fa._dq_kernel = lambda: fn

    def time_ms():
        return chip_smoke._time_ms(lambda: fa.launch_dq(q, k, v, o, lse, do, True), 100)

    report = {}
    for name, (fn, occ) in kernels.items():
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        if occ(64, ctypes.byref(smem), ctypes.byref(blocks)) != 0:
            raise RuntimeError(f"{name}: occupancy query failed")
        use(fn)
        worst, identical = 0.0, True
        for args, ref in cases:
            got, again = fa.launch_dq(*args), fa.launch_dq(*args)
            worst = max(worst, ((got - ref).abs().max() / max(ref.abs().max().item(), 1.0)).item())
            identical &= torch.equal(got, again)
        f64, plain_f64 = chip_smoke.float64_errors(
            (q, k, v, o, lse, do), True, (fa.launch_dq(q, k, v, o, lse, do, True),))["dq"]
        times = []
        for fn_turn in (base_fn, fn, fn, base_fn):
            use(fn_turn)
            times.append(time_ms())
        use(fn)
        errors = chip_smoke.gradient_and_loss_errors(card, rows, spec)
        report[name] = {
            "registers_dh64": _dq_registers(built[name][1]), "sass_hmma": sum(
                n for f, n in chip_smoke._sass_hmma({name: built[name][0]}).items()
                if "flash_bwd_dq_f32" in f),
            "smem_bytes_dh64": smem.value, "blocks_per_sm_dh64": blocks.value,
            "max_rel_err": worst, "bit_identical": bool(identical),
            "f64_max_rel_err": f64, "plain_f32_f64_max_rel_err": plain_f64,
            "ms": times[1:3], "source_ms": [times[0], times[3]],
            "gates_hold": errors["grad"] <= chip_smoke.TOL_GRAD_REL
            and errors["grad_bk"] <= chip_smoke.TOL_GRAD_REL
            and errors["loss"] <= chip_smoke.TOL_LOSS_REL, **errors,
        }
        r = report[name]
        print(f"{name} on {card}: {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms (source "
              f"{r['source_ms'][0]:.4f} / {r['source_ms'][1]:.4f}); registers "
              f"{r['registers_dh64']}; {r['smem_bytes_dh64']} B, {r['blocks_per_sm_dh64']} "
              f"blocks per SM; {r['sass_hmma']} HMMA; max rel err {worst:.3e}, bit-identical "
              f"{identical}; against float64 {f64:.3e} (plain float32 {plain_f64:.3e}); "
              f"gradients {errors['grad']:.3e} (bk {errors['grad_bk']:.3e}), losses "
              f"{errors['loss']:.3e}", flush=True)
    print(json.dumps({"card": card, "variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
