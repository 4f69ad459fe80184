// The launch plan of the LSTM recurrence kernels (lstm_recurrence.cu): which
// route a shape takes, the batch rows and cluster of a CTA, its threads and
// shared memory, and the index maps the kernels and the plan share (the
// gate-interleaved order of the recurrent kernel's columns, and the (unit,
// batch row) cells a thread owns). Plain C++ with no CUDA header, so that
// the same code is compiled by nvcc into the kernels' library and by a host
// C++ compiler for the CPU tests (tests/test_torch_lstm_tcn.py), which hold
// every plan and map without a card:
//
//   g++ -x c++ -std=c++17 -O2 -shared -fPIC -o libplan.so lstm_plan.cuh
//
// The routes:
// - CLUSTER: the tensor-core kernels with the recurrent kernel R held in
//   shared memory for the whole sequence, split over a thread-block cluster
//   (1 to 16 CTAs; each CTA owns U / cluster units);
// - STREAM: the same kernels where even a cluster of 16 cannot hold R: each
//   CTA reads its slice of R from L2 once a step (wider than any factory's
//   layer; it beat the legacy route at every width timed there);
// - LEGACY: the CUDA-core kernels of the first port of the recurrence, for
//   units below LEGACY_BELOW and for shapes whose step buffers no
//   tensor-core route can hold (the widest U at a large batch).

#ifndef GORDO_LSTM_PLAN_CUH
#define GORDO_LSTM_PLAN_CUH

#if defined(__CUDACC__)
#define GORDO_HD __host__ __device__ __forceinline__
#else
#define GORDO_HD inline
#endif

namespace gordo_lstm {

enum Route { LEGACY = 0, CLUSTER = 1, STREAM = 2, N_ROUTES = 3 };

// cudaError_t's values, returned by the plan where it refuses a shape
constexpr int PLAN_OK = 0;
constexpr int PLAN_INVALID_VALUE = 1;

constexpr int SMS = 132;          // streaming multiprocessors of an H100 SXM
constexpr int MAX_SMEM = 232448;  // the most dynamic shared memory a block takes
constexpr int MAX_THREADS = 512;  // a tensor-core CTA (at most 128 registers a thread)
constexpr int LEGACY_THREADS = 256;
// clusters above 8 CTAs (the plan's largest is 16) need
// cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int PORTABLE_CLUSTER = 8;
constexpr int UNIT_TILE = 16;  // units are padded to a multiple: an m16 tile, a k16 step
constexpr int UNIT_BLOCK = 8;  // units whose four gates one forward m16 pair holds
// units below this take the legacy route: U 2 and 3 (examples/config.yaml's
// compressor-b) would pad to 16, and its step is host-bound anyway
constexpr int LEGACY_BELOW = 8;
// so do float32 layers of at most this many units over at most SMS rows
// (M B), where the legacy kernels run a block a row with R in shared memory
// and their float32 step's latency beat every tensor-core plan's
// (lstm_ae_144 at U 64 and 32 over 64 windows; bf16 there is faster on the
// tensor cores: scripts/torch_lstm_ab.py --sweep on an H100)
constexpr int LEGACY_MAX_UNITS = 64;
constexpr int ROW_TILES[3] = {8, 16, 32};  // batch rows a CTA: n8 tiles of the mma
constexpr int CLUSTERS[5] = {1, 2, 4, 8, 16};

GORDO_HD int padded_units(int u) { return (u + UNIT_TILE - 1) / UNIT_TILE * UNIT_TILE; }

// Row stride (elements) of a shared-memory tile of `cols` columns (a multiple
// of 16): the fragment loads of 8 rows x 4 words then fall on 32 distinct
// banks (a stride of 4 x an odd number of words)
GORDO_HD int row_stride(int cols, int elem_bytes) { return cols + (elem_bytes == 2 ? 8 : 4); }

// The gate-interleaved order of the forward product's rows (R's columns):
// position q of the 4 Up positions is unit block q / 32 (8 units), gate
// (q % 32) / 8 (i, f, g, o) and unit (q / 32) * 8 + q % 8, so an m16 tile
// holds two gates of 8 units and the thread holding the accumulator of
// (unit, row) in the pair of m16 tiles of a unit block holds all four
// gates. Returns the column of R (gate * u + unit), -1 for a padded unit.
GORDO_HD int interleaved_column(int u, int q) {
  const int unit = (q / 32) * UNIT_BLOCK + q % UNIT_BLOCK;
  return unit < u ? ((q % 32) / UNIT_BLOCK) * u + unit : -1;
}

// The cell (unit, batch row in the machine) of slot `s` of a thread. A
// warp is (k part, tile of the CTA): `ksplit` warps share a tile, each
// summing 1 / ksplit of the product's K, and each then finishes 1 / ksplit
// of the tile's cells (slot s of k part kp is cell kp * (cells / ksplit) +
// s of its lane). Forward, a tile is a unit block of 8 units (warp tile %
// blocks) x tiles_a_warp n-tiles of 8 rows from (tile / blocks) *
// tiles_a_warp; lane (g, q) = (lane / 4, lane % 4) holds unit g of the block
// and rows 2q, 2q + 1 of each n-tile: cell c = (n-tile c / 2, row c % 2).
// Backward, a tile is an m16 tile of units (tile % m-tiles) x an n-tile
// (tile / m-tiles); the lane holds units g and g + 8 and rows 2q, 2q + 1:
// cell c = (unit c / 2, row c % 2). `uc` is the CTA's units, `rank` its
// place in the cluster, `tile_row` its row tile.
GORDO_HD int cells_a_lane(int backward, int tiles_a_warp) {
  return backward ? 4 : 2 * tiles_a_warp;
}

GORDO_HD void cell_of(int backward, int uc, int rows, int tiles_a_warp, int ksplit, int rank,
                      int tile_row, int warp, int lane, int s, int* unit, int* row) {
  const int g = lane / 4, q = lane % 4;
  const int kp = warp % ksplit, tile = warp / ksplit;
  const int c = kp * (cells_a_lane(backward, tiles_a_warp) / ksplit) + s;
  if (backward) {
    const int tiles = uc / UNIT_TILE;
    *unit = rank * uc + (tile % tiles) * UNIT_TILE + g + 8 * (c / 2);
    *row = tile_row * rows + (tile / tiles) * 8 + 2 * q + c % 2;
  } else {
    const int blocks = uc / UNIT_BLOCK;
    *unit = rank * uc + (tile % blocks) * UNIT_BLOCK + g;
    *row = tile_row * rows + ((tile / blocks) * tiles_a_warp + c / 2) * 8 + 2 * q + c % 2;
  }
}

struct Plan {
  int route;         // Route
  int rows;          // batch rows a CTA; the legacy route's batch tile
  int cluster;       // CTAs a cluster, 1 without one
  int threads;       // a CTA
  int smem;          // dynamic shared memory, bytes
  int r_in_smem;     // R held in shared memory for the whole sequence
  int tiles_a_warp;  // n-tiles of 8 rows a forward warp takes (1 or 2); 1 backward
  int ksplit;        // warps that split a tile's K (forward 1 or 2, backward 2 or 4)
};

// ------------------------------------------------------------ legacy route
// threads of a block for U units: one per gate column up to LEGACY_THREADS
GORDO_HD int legacy_threads(int u) {
  const int cols = ((4 * u + 31) / 32) * 32;
  return cols < LEGACY_THREADS ? cols : LEGACY_THREADS;
}

// groups of threads that split the legacy backward's 4U-long sums of dz R^T
GORDO_HD int legacy_parts(int u, int nt) { return u >= nt ? 1 : nt / u; }

// dynamic shared memory of the legacy step buffers, without R
// (forward: h, c, z; backward: dc, dz and the partial sums of dz R^T)
inline long long legacy_buffer_bytes(int u, int bt, int backward) {
  if (!backward) return 4 * 6LL * bt * u;
  return 4 * (5LL + legacy_parts(u, legacy_threads(u))) * bt * u;
}

// bt is the batch tile the wrapper chose (1, 2, 4 or 8); an error, with the
// step buffers' bytes in p->smem (saturated at INT_MAX), where those alone
// exceed MAX_SMEM
inline int legacy_plan(int u, int bt, int elem_bytes, int backward, Plan* p) {
  const long long base = legacy_buffer_bytes(u, bt, backward);
  const long long r_bytes = static_cast<long long>(u) * 4 * u * elem_bytes;
  p->route = LEGACY;
  p->rows = bt;
  p->cluster = 1;
  p->threads = legacy_threads(u);
  p->r_in_smem = base + r_bytes <= MAX_SMEM;
  const long long smem = p->r_in_smem ? base + r_bytes : base;
  p->smem = static_cast<int>(smem < 2147483647LL ? smem : 2147483647LL);
  p->tiles_a_warp = 1;
  p->ksplit = 1;
  return base > MAX_SMEM ? PLAN_INVALID_VALUE : PLAN_OK;
}

// ------------------------------------------------------------ tensor-core routes
// threads of a CTA of `uc` units and `rows` batch rows: ksplit warps per
// tile, a tile forward a unit block x tiles_a_warp n-tiles, backward an m16
// tile x an n-tile
GORDO_HD int tc_threads(int uc, int rows, int tiles_a_warp, int ksplit, int backward) {
  const int n_tiles = rows / 8;
  return 32 * ksplit * (backward ? (uc / UNIT_TILE) * n_tiles
                                 : (uc / UNIT_BLOCK) * (n_tiles / tiles_a_warp));
}

// dynamic shared memory: held, the CTA's slice of R in fragment order
// (forward 4 uc interleaved gate rows x Up, backward uc unit rows x 4 Up;
// float32 split into TF32 big and small, 8 bytes an element; bf16 2), the
// double-buffered B operand (forward h, backward dz: rows x K in the input
// dtype), and the k parts' partial sums (a float per accumulator of every
// thread) where ksplit > 1
inline long long tc_smem(int up, int uc, int rows, int tiles_a_warp, int ksplit, int elem_bytes,
                         int backward, int held) {
  const long long k = backward ? 4LL * up : up;
  const long long r_rows = backward ? uc : 4LL * uc;
  const long long frags = held ? r_rows * k * (elem_bytes == 4 ? 8 : 2) : 0;
  const long long buffers = 2LL * rows * row_stride(static_cast<int>(k), elem_bytes) * elem_bytes;
  const long long partials =
      ksplit > 1 ? 4LL * tc_threads(uc, rows, tiles_a_warp, ksplit, backward) *
                       (backward ? 4 : 8 * tiles_a_warp)
                 : 0;
  return frags + buffers + partials;
}

// A measurement hook's choice: a route, and for the tensor-core routes a
// cluster size, a row tile and a k split; -1 leaves each to the plan's rule
struct Force {
  int route, cluster, rows, ksplit;
};

// CTAs of `smem` bytes and `threads` that an SM holds at once: 228 KiB of
// shared memory (1 KiB of it reserved a CTA), 2,048 threads, 32 CTAs
inline int ctas_an_sm(long long smem, int threads) {
  const long long by_smem = 233472 / (smem + 1024), by_threads = 2048 / threads;
  const long long n = by_smem < by_threads ? by_smem : by_threads;
  return static_cast<int>(n < 32 ? n : 32);
}

// The route's plan. Of the clusters that split the padded units into whole
// tiles (forward: unit blocks of 8; backward: m16 tiles of 16 units) and the
// row tiles 8, 16 and 32, each with its layout, within 512 threads and the
// shared memory: the fewest waves of CTAs over the SMS SMs (as many a wave
// as an SM holds at once); then the most CTAs up to FULL (a step's latency
// falls as its work spreads over idle SMs); then the smallest cluster (its
// barrier and DSMEM stores cost a step more than a CTA barrier; STREAM: the
// largest, which streams the fewest bytes a CTA); then the most CTAs and
// the smaller row tile. Where one CTA holds R, no cluster: spreading a
// small R over a cluster to fill SMs was slower on the card (bf16 U 64 over
// 64 rows); where R needs a cluster, larger ones spread it (the default
// width ran fastest over 16 CTAs). A tile's layout: one
// n-tile a warp and the smallest k split (backward: 2 or 4) whose warps,
// over all CTAs, reach MIN_WARPS (the k split's extra barrier and partial
// sums pay only where warps are few), else the largest; a forward warp takes
// two n-tiles where one would pass 512 threads.
constexpr long long MIN_WARPS = 8LL * SMS;
constexpr long long FULL = 3LL * SMS / 4;

inline int tc_plan(int m, int b, int u, int elem_bytes, int backward, int route, Force force,
                   Plan* p) {
  const int up = padded_units(u), k_step = elem_bytes == 4 ? 8 : 16;
  const int tile_units = backward ? UNIT_TILE : UNIT_BLOCK;
  const int k_steps = (backward ? 4 * up : up) / k_step;
  const bool held = route == CLUSTER;
  // (tiles_a_warp, ksplit) by rising k split; STREAM is built in one layout
  // a direction (forward (1, 1), backward (1, 2))
  const int layouts[4][2] = {{1, 1}, {1, 2}, {1, 4}, {2, 1}};
  bool found = false;
  long long chosen_waves = 0, chosen_fill = 0, chosen_ctas = 0;
  for (int c = 0; c < 5; ++c) {
    const int cluster = CLUSTERS[c];
    if (up % (tile_units * cluster) || (force.cluster > 0 && cluster != force.cluster)) continue;
    if (held && force.cluster <= 0 && found && p->cluster == 1) break;  // one CTA holds R
    const int uc = up / cluster;
    for (int rows : ROW_TILES) {
      if (force.rows > 0 && rows != force.rows) continue;
      const long long ctas = static_cast<long long>(m) * ((b + rows - 1) / rows) * cluster;
      int layout = -1;
      for (int l = 0; l < 4; ++l) {
        const int ntw = layouts[l][0], ks = layouts[l][1];
        const bool built = backward ? ntw == 1 && ks >= 2 && (held || ks == 2)
                                    : ks <= 2 && (held || (ntw == 1 && ks == 1));
        if (!built || k_steps % ks || (rows / 8) % ntw ||
            (force.ksplit > 0 && ks != force.ksplit) ||
            tc_threads(uc, rows, ntw, ks, backward) > MAX_THREADS ||
            tc_smem(up, uc, rows, ntw, ks, elem_bytes, backward, held) > MAX_SMEM) {
          continue;
        }
        if (ntw == 2 && layout >= 0) break;  // one n-tile a warp fits
        layout = l;
        if (ctas * tc_threads(uc, rows, ntw, ks, backward) / 32 >= MIN_WARPS) break;
      }
      if (layout < 0) continue;
      const int ntw = layouts[layout][0], ks = layouts[layout][1];
      const int threads = tc_threads(uc, rows, ntw, ks, backward);
      const long long smem = tc_smem(up, uc, rows, ntw, ks, elem_bytes, backward, held);
      const long long wave = static_cast<long long>(SMS) * ctas_an_sm(smem, threads);
      const long long waves = (ctas + wave - 1) / wave, fill = ctas < FULL ? ctas : FULL;
      const bool smaller = held ? cluster < p->cluster : cluster > p->cluster;
      const bool better =
          !found || waves < chosen_waves ||
          (waves == chosen_waves &&
           (fill > chosen_fill ||
            (fill == chosen_fill &&
             (smaller || (cluster == p->cluster && ctas > chosen_ctas)))));
      if (!better) continue;
      found = true;
      chosen_waves = waves;
      chosen_fill = fill;
      chosen_ctas = ctas;
      p->route = route;
      p->rows = rows;
      p->tiles_a_warp = ntw;
      p->ksplit = ks;
      p->cluster = cluster;
      p->threads = threads;
      p->smem = static_cast<int>(smem);
      p->r_in_smem = held;
    }
  }
  return found ? PLAN_OK : PLAN_INVALID_VALUE;
}

// The plan of a launch: the legacy route at batch tile bt for U below
// LEGACY_BELOW, and for float32 U up to LEGACY_MAX_UNITS over at most SMS
// rows where the legacy kernels hold R in shared memory; else the tensor-core
// routes (held R first, then streamed), and the legacy route where neither
// fits. A forced route takes that route alone, a forced cluster, row tile
// or k split those alone (a measurement hook: scripts/torch_lstm_ab.py, the
// card's tests).
inline int plan(int m, int b, int u, int bt, int elem_bytes, int backward, Force force,
                Plan* p) {
  if (force.route == CLUSTER || force.route == STREAM) {
    return tc_plan(m, b, u, elem_bytes, backward, force.route, force, p);
  }
  Plan legacy{};
  const bool legacy_first =
      u < LEGACY_BELOW ||
      (elem_bytes == 4 && u <= LEGACY_MAX_UNITS && static_cast<long long>(m) * b <= SMS &&
       legacy_plan(u, bt, elem_bytes, backward, &legacy) == PLAN_OK && legacy.r_in_smem);
  if (force.route < 0 && !legacy_first) {
    if (tc_plan(m, b, u, elem_bytes, backward, CLUSTER, force, p) == PLAN_OK) return PLAN_OK;
    if (tc_plan(m, b, u, elem_bytes, backward, STREAM, force, p) == PLAN_OK) return PLAN_OK;
  }
  return legacy_plan(u, bt, elem_bytes, backward, p);
}

}  // namespace gordo_lstm

// The entry points of the plan and the forced route they plan with, defined
// in one translation unit of a build: this header compiled alone (the CPU
// tests' host build), or lstm_recurrence.cu whole or as its part 0 (its
// other parts, ops/_build.py PARTS, hold kernels only).
#if !defined(GORDO_PART) || GORDO_PART <= 0
namespace gordo_lstm {
// the route, cluster, row tile and k split of every launch: -1 for the
// plan's own rule (gordo_lstm_set_route)
Force forced = {-1, -1, -1, -1};
}  // namespace gordo_lstm

// Every later launch and plan takes `route` (gordo_lstm::Route) and, on a
// tensor-core route, `cluster` CTAs a cluster, `rows` batch rows a CTA and
// `ksplit` warps a tile; -1 leaves each to the plan's rule. A measurement
// hook, so that one library can be held and timed on each route and plan; a
// launch the forced plan cannot take fails. Returns 1 (cudaErrorInvalidValue)
// for a route out of range.
extern "C" int gordo_lstm_set_route(int route, int cluster, int rows, int ksplit) {
  if (route < -1 || route >= gordo_lstm::N_ROUTES) return gordo_lstm::PLAN_INVALID_VALUE;
  gordo_lstm::forced = gordo_lstm::Force{route, cluster, rows, ksplit};
  return gordo_lstm::PLAN_OK;
}

// The plan of a launch under the forced route (see gordo_lstm::plan), for
// the wrapper's checks and for reports. Returns the CUDA error code: nonzero
// where no route takes the shape, the legacy route's step-buffer bytes then
// in smem_bytes.
extern "C" int gordo_lstm_plan(int m, int b, int u, int bt, int elem_bytes, int backward,
                               int* route, int* rows, int* cluster, int* threads,
                               int* smem_bytes, int* r_in_smem, int* tiles_a_warp, int* ksplit) {
  gordo_lstm::Plan p{};
  const int err = gordo_lstm::plan(m, b, u, bt, elem_bytes, backward, gordo_lstm::forced, &p);
  *route = p.route;
  *rows = p.rows;
  *cluster = p.cluster;
  *threads = p.threads;
  *smem_bytes = p.smem;
  *r_in_smem = p.r_in_smem;
  *tiles_a_warp = p.tiles_a_warp;
  *ksplit = p.ksplit;
  return err;
}

// interleaved_column and cell_of, for the CPU tests' checks of the maps
extern "C" int gordo_lstm_interleaved_column(int u, int q) {
  return gordo_lstm::interleaved_column(u, q);
}

extern "C" void gordo_lstm_cell_of(int backward, int uc, int rows, int tiles_a_warp,
                                   int ksplit, int rank, int tile_row, int warp, int lane, int s,
                                   int* unit, int* row) {
  gordo_lstm::cell_of(backward, uc, rows, tiles_a_warp, ksplit, rank, tile_row, warp, lane, s,
                      unit, row);
}
#endif  // GORDO_PART

#endif  // GORDO_LSTM_PLAN_CUH
