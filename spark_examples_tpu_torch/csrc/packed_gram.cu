// Packed-gram contraction for Hopper (sm_90a): 2-bit packed genotype
// bytes in, one int32 pair-count matrix per requested product out, on the
// int8 tensor cores through warpgroup MMA (wgmma).
//
// Replaces: spark_examples_tpu/ops/pallas/packed_gram.py,
// fused_tile_products (kernel body _make_kernel / _plane_operands), the
// TPU kernel that decodes the packed codes per bit plane and contracts
// the indicator operands on the MXU.
//
// What it computes. rows (nr, w) and cols (nc, w) hold four 2-bit codes
// per byte (variant v in byte v/4, bits 2*(v%4)): 0, 1, 2 = dosage,
// 3 = missing. Each code decodes to the indicators
//     c = [code != 3], t1 = [code in {1,2}], t2 = [code == 2], y = t1 + t2
// and product p = (L, R) is out[p][i][j] = sum_v L(rows[i], v) * R(cols[j], v).
// Integer sums are exact in any order, so the result is bit-identical to
// the TPU kernel and to the plain version whatever order, and whatever
// assignment of variants to the tensor cores' k lanes, the sum takes, as
// long as both operands use the same assignment.
//
// What bounds it. At the main path's shapes the work the output needs is
// int8 operations: 2.6e11 at (2504 samples, 2048 bytes), 0.13 ms at the
// card's 1,979 TOP/s; 2.0e13 at (15,708, 4,096 B), 10.2 ms. The packed
// bytes read are 16x fewer than the int32 outputs written. Only wgmma
// reaches the int8 rate (mma.sync, this kernel's first design, ran at a
// quarter of it).
//
// What this design does about it.
// - Work items. The output is cut into 128 x 128 tiles (the I <= J tiles
//   of a symmetric launch, the full grid otherwise), and the launch's
//   contractions into sweeps of at most two (two m64n128 s32 accumulator
//   sets are 128 registers a thread; three would spill). An item is one
//   (sweep, tile); a grid of at most one block per SM walks the items
//   sweep-major, block b taking items b, b + grid, ... . Sweep-major
//   mixes two-contraction and one-contraction sweeps in every block (an
//   item-major walk would give block b only sweep b % 3 when the grid is
//   a multiple of three), and the items of a small launch still fill the
//   card: (2504, 2048 B) ibs is 210 tiles x 3 sweeps = 630 items.
// - Roles. Warps 8-11 are the producer warpgroup: they copy each item's
//   packed stages (32 bytes = 128 variants of 128 rows and 128 columns)
//   with 16-byte cp.async into a ring of 4 stages, each guarded by a full
//   and an empty mbarrier, and run ahead into the next item while the
//   consumers store one. Warps 0-7 are two consumer warpgroups, one per
//   64 rows of the tile; setmaxnreg moves registers from the producers
//   (56 a thread) to them (224). A width that is not a multiple of 16, or
//   an unaligned pointer, takes plain byte loads into the same ring.
// - Decode once per block. The consumers decode each stage's column bytes
//   once into int8 B tiles in shared memory, in wgmma's K-major layout
//   without swizzle (8 x 16-byte core matrices, 128 bytes each), one tile
//   per distinct right operand of the sweep, which both warpgroups read.
//   A stays in registers: each thread turns one 32-bit word of 16 packed
//   variants into PRMT selectors (nibble n of (word & 0x33333333) is the
//   code of variant 2n, of ((word >> 2) & 0x33333333) that of 2n+1) and
//   one PRMT against a 4-byte lookup word (byte k = the operand's value
//   for code k) gives a 4-variant fragment register. The B decode uses
//   the same selectors, so A and B agree on which variant sits in which k
//   lane, and the lookup words keep every contraction's operands a
//   runtime choice.
// - Overlap. wgmma is asynchronous: a stage's B tiles are decoded while
//   the previous stage's wgmmas run, into one of three decode buffers (a
//   buffer is rewritten only after both warpgroups have retired the
//   wgmmas that read it, which their barrier of the step before
//   guarantees), and A fragments alternate between two register sets,
//   each k32 step waiting for all but the last group in flight.
// - A ragged byte tail is masked in the selectors: OR-ing 0x4 into a
//   nibble selects a byte of the zero word, so bytes past w contribute
//   nothing whatever shared memory holds there. Out-of-range rows and
//   columns are never loaded: their accumulators are garbage and are
//   never stored.
// - Symmetric launches run only the tiles with I <= J. The launch carries
//   a plan of contractions (built in Python,
//   ops/packed_gram.py::contraction_plan): each contraction (L, R) writes
//   its tile to [I, J] of product `direct` and its transpose to [J, I] of
//   product `mirror`. (L, L) products are their own mirror; an (L, R)
//   product takes its [J, I] tile from the partner contraction (R, L),
//   since out[j][i] = sum L_j R_i. The diagonal tile is written once.
//   Transposed stores go through a padded shared tile (laid over the
//   decode buffers, idle in the epilogue) so they coalesce.
// - The launch geometry (tile, sweeps of consecutive plan entries, grid)
//   is ops/packed_gram.py::launch_plan's, which the CPU tests hold.
// Further speed work is ROADMAP Queue 4.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KB = 32;               // packed bytes per stage (128 variants)
constexpr int CHUNKS = KB / 16;      // 16-byte chunks per row per stage
constexpr int STAGES = 4;            // packed ring
constexpr int DEC_BUFS = 3;          // decoded B tiles in flight
constexpr int N_OPERANDS = 4;        // c, t1, t2, y (the Python side's codes)
constexpr int MAX_PRODUCTS = 7;
constexpr int MAX_CONTRACTIONS = 2 * MAX_PRODUCTS;
constexpr int G_MAX = 2;             // contractions per sweep

constexpr int TILE = 128;
constexpr int CONSUMERS = 256;       // two warpgroups, 64 rows each
constexpr int PRODUCERS = 128;       // one warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
// setmaxnreg moves registers only within the block: the producers give
// back (168 - 56) x 128, the consumers take (224 - 168) x 256 (at 48 the
// producers' byte-load path spills).
static_assert(CONSUMERS * CONSUMER_REGS + PRODUCERS * PRODUCER_REGS <= 65536,
              "the roles' registers fit the SM's file");
constexpr int RING_STAGE = 2 * TILE * KB;        // rows' and cols' bytes
constexpr int OP_BYTES = TILE * 4 * KB;          // one decoded B tile
constexpr int DEC_BYTES = G_MAX * OP_BYTES;
constexpr int CORE_COLS = TILE / 8;              // core matrices along N
constexpr int KSTEP_BYTES = 2 * CORE_COLS * 128; // one k32 step of B
constexpr int SMEM = DEC_BUFS * DEC_BYTES + STAGES * RING_STAGE +
                     2 * STAGES * 8;
static_assert(TILE * (TILE + 1) * 4 <= DEC_BUFS * DEC_BYTES,
              "the transpose tile fits over the decode buffers");
static_assert(2 * TILE * CHUNKS % PRODUCERS == 0,
              "whole copies a producer thread");
static_assert(TILE * CHUNKS == CONSUMERS, "one B decode task a consumer");

struct Plan {
  uint32_t lut_left[MAX_CONTRACTIONS];
  uint32_t lut_right[MAX_CONTRACTIONS];
  int direct[MAX_CONTRACTIONS];   // product written at [I, J], or -1
  int mirror[MAX_CONTRACTIONS];   // product written transposed at [J, I], or -1
  int n;
};

// plan.<field>[i] for a runtime i without indexing the parameter array
// (which would copy the plan to local memory).
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[MAX_CONTRACTIONS], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < MAX_CONTRACTIONS; ++k)
    if (k == i) v = a[k];
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The barrier counts one arrival from this lane once its earlier
// cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The consumers' own barrier (warps 0-7); the producer never joins it.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of `d` across the
// wgmma fences and waits around it.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A K-major shared-memory operand without swizzle: core matrices of 8
// rows x 16 bytes, `lbo` bytes apart along K, `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 rows x 128 columns, s32) += a (64 x 32 s8, registers) * b (32 x
// 128 s8, shared memory).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// The operand word for four variants: byte n is byte (nibble n of sel) of
// the lookup word, or of zero for nibbles 4-7. Inline PTX, because
// __byte_perm clears bit 3 of every nibble and the high half first (one
// LOP3 per call); the selectors here never set bit 3, and prmt ignores
// the high half.
__device__ __forceinline__ uint32_t lookup(uint32_t lut, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(lut), "r"(0u), "r"(sel));
  return d;
}

// Four PRMT selectors from one word of 16 packed variants, with the tail
// mask `m` applied: [0] and [1] feed the first k32 half's k slots 4t and
// 16 + 4t, [2] and [3] the second's. PRMT reads only the low 16 bits of a
// selector.
__device__ __forceinline__ void selectors(uint32_t word, uint32_t m,
                                          uint32_t (&s)[4]) {
  const uint32_t even = (word & 0x33333333u) | m;
  const uint32_t odd = ((word >> 2) & 0x33333333u) | m;
  s[0] = even;
  s[1] = odd;
  s[2] = even >> 16;
  s[3] = odd >> 16;
}

// 0x4 in every nibble of the bytes of a word past w: `left` bytes of w
// remain from the word's first byte.
__device__ __forceinline__ uint32_t tail_mask(int left) {
  return left >= 4 ? 0u
                   : (left <= 0 ? 0x44444444u : 0x44444444u << (8 * left));
}

// The producer thread p's share of a stage: chunk p % CHUNKS of COPIES
// samples (rows p / CHUNKS and p / CHUNKS + 64 of each side), stored as
// [side][chunk][sample][16 bytes]. The sources are fixed for an item.
constexpr int COPIES = 2 * TILE * CHUNKS / PRODUCERS;
static_assert(PRODUCERS % CHUNKS == 0, "one chunk a producer thread");

struct Copies {
  const uint8_t* src[COPIES];  // the sample's chunk in stage 0, or null
  int chunk;
};

__device__ __forceinline__ Copies item_copies(const uint8_t* rows,
                                              const uint8_t* cols, int row0,
                                              int col0, int nr, int nc,
                                              int w, int p) {
  Copies c;
  c.chunk = p % CHUNKS;
#pragma unroll
  for (int i = 0; i < COPIES; ++i) {
    const int idx = p + PRODUCERS * i;
    const int r = (idx / CHUNKS) % TILE;
    const int side = idx / (CHUNKS * TILE);
    const int sample = (side ? col0 : row0) + r;
    c.src[i] = sample < (side ? nc : nr)
                   ? (side ? cols : rows) + static_cast<size_t>(sample) * w +
                         c.chunk * 16
                   : nullptr;
  }
  return c;
}

template <bool ALIGNED>
__device__ __forceinline__ void load_stage(uint8_t* dst, const Copies& c,
                                           int w, int kc, int p) {
  const int k = kc * KB + c.chunk * 16;  // the chunk's first byte
  if (k >= w) return;
#pragma unroll
  for (int i = 0; i < COPIES; ++i) {
    if (c.src[i] == nullptr) continue;
    const int idx = p + PRODUCERS * i;
    uint8_t* d = dst + (idx / (CHUNKS * TILE)) * (TILE * KB) +
                 (c.chunk * TILE + (idx / CHUNKS) % TILE) * 16;
    const uint8_t* src = c.src[i] + kc * KB;
    if constexpr (ALIGNED) {
      cp_async16(d, src);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t byte = k + 4 * q + e < w ? src[4 * q + e] : 0xFFu;
          v[q] |= byte << (8 * e);
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

struct Geometry {
  int nr, nc, w, symmetric;
  int tiles_c, tiles, nk, items;
};

// Item -> (sweep, tile row, tile column): sweep-major; a symmetric
// launch's tiles are the I <= J ones, row-major.
__device__ __forceinline__ void item_tile(const Geometry& g, int item,
                                          int& sweep, int& ti, int& tj) {
  sweep = item / g.tiles;
  const int t = item - sweep * g.tiles;
  if (g.symmetric) {
    // Row i starts at s(i) = i * T - i * (i - 1) / 2; the estimate from
    // the quadratic is corrected by at most a step each way.
    const int T = g.tiles_c;
    const float b = 2.0f * T + 1.0f;
    int i = static_cast<int>((b - sqrtf(fmaxf(b * b - 8.0f * t, 0.0f))) *
                             0.5f);
    i = max(0, min(i, T - 1));
    while (i > 0 && i * T - i * (i - 1) / 2 > t) --i;
    while (i + 1 < T && (i + 1) * T - (i + 1) * i / 2 <= t) ++i;
    ti = i;
    tj = i + (t - (i * T - i * (i - 1) / 2));
  } else {
    ti = t / g.tiles_c;
    tj = t - ti * g.tiles_c;
  }
}

// One item's mainloop and epilogue on the consumer warpgroups, G
// contractions starting at plan entry q0. `s` counts the block's stages.
template <int G>
__device__ __forceinline__ void consume_item(
    const Geometry& geo, const Plan& plan, int32_t* __restrict__ out,
    uint8_t* dec, const uint8_t* ring, uint64_t* full, uint64_t* empty,
    int q0, int ti, int tj, int& s) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = ti * TILE;
  const int col0 = tj * TILE;

  uint32_t la[G];
#pragma unroll
  for (int q = 0; q < G; ++q) la[q] = pick(plan.lut_left, q0 + q);
  const uint32_t rb0 = pick(plan.lut_right, q0);
  const uint32_t rb1 = G > 1 ? pick(plan.lut_right, q0 + 1) : rb0;
  const int nb = rb1 == rb0 ? 1 : 2;  // distinct right operands
  const int b1 = (nb - 1) * OP_BYTES;  // the second contraction's B tile

  int acc[G][64];
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[q][i] = 0;
    fence_acc(acc[q]);
  }
  uint32_t areg[2][G][4];

  // The B decode task of this thread: column n, chunk c of each stage.
  const int bn = tid % TILE;
  const int bc = tid / TILE;
  const int bdst = (bn >> 3) * 128 + (bn & 7) * 16;
  // Rows of this thread's A fragments.
  const int ar = wg * 64 + warp * 16 + g;

  for (int kc = 0; kc < geo.nk; ++kc, ++s) {
    const int slot = s % STAGES;
    mbar_wait(&full[slot], (s / STAGES) & 1);
    const uint8_t* st = ring + slot * RING_STAGE;
    uint8_t* db = dec + (s % DEC_BUFS) * DEC_BYTES;

    {  // B: this thread's 64 variants of one column, every right operand.
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + TILE * KB + (bc * TILE + bn) * 16);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      const int left = geo.w - (kc * KB + bc * 16);
      uint32_t sel[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        selectors(words[u], tail_mask(left - 4 * u), sel[u]);
#pragma unroll
      for (int o = 0; o < G; ++o) {
        if (o >= nb) break;
        const uint32_t lut = o ? rb1 : rb0;
        uint8_t* base = db + o * OP_BYTES + bdst;
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // core column 4 * bc + h
          *reinterpret_cast<uint4*>(base + (4 * bc + h) * CORE_COLS * 128) =
              make_uint4(lookup(lut, sel[0][h]), lookup(lut, sel[1][h]),
                         lookup(lut, sel[2][h]), lookup(lut, sel[3][h]));
        }
      }
    }
    uint32_t wa[CHUNKS][2];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wa[c][h] = *reinterpret_cast<const uint32_t*>(
            st + (c * TILE + ar + 8 * h) * 16 + 4 * t);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    fence_async_shared();
    consumers_sync();

#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const uint32_t m = tail_mask(geo.w - (kc * KB + c * 16 + 4 * t));
      uint32_t s0[4], s1[4];
      selectors(wa[c][0], m, s0);
      selectors(wa[c][1], m, s1);
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int j = 2 * c + k2;  // k32 step within the stage
        wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < G; ++q) {
          areg[k2][q][0] = lookup(la[q], s0[2 * k2]);
          areg[k2][q][1] = lookup(la[q], s1[2 * k2]);
          areg[k2][q][2] = lookup(la[q], s0[2 * k2 + 1]);
          areg[k2][q][3] = lookup(la[q], s1[2 * k2 + 1]);
        }
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < G; ++q)
          wgmma_m64n128k32(acc[q], areg[k2][q],
                           smem_desc(db + (q ? b1 : 0) + j * KSTEP_BYTES,
                                     CORE_COLS * 128, 128));
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < G; ++q) fence_acc(acc[q]);

  // Epilogue: direct stores from registers, mirrors through shared memory.
  const int nr = geo.nr, nc = geo.nc;
  const bool pair = (nc % 2) == 0;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int cq = q0 + q;
    const int dst = pick(plan.direct, cq);
    if (dst >= 0) {
      int32_t* base = out + static_cast<size_t>(dst) * nr * nc;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + ar + 8 * h;
          const int c = col0 + 8 * i + 2 * t;
          if (r >= nr || c >= nc) continue;
          int32_t* o = base + static_cast<size_t>(r) * nc + c;
          if (pair) {
            *reinterpret_cast<int2*>(o) =
                make_int2(acc[q][4 * i + 2 * h], acc[q][4 * i + 2 * h + 1]);
          } else {
            o[0] = acc[q][4 * i + 2 * h];
            if (c + 1 < nc) o[1] = acc[q][4 * i + 2 * h + 1];
          }
        }
    }
    const int mir = pick(plan.mirror, cq);
    if (geo.symmetric && mir >= 0 && ti != tj) {
      int32_t* tr = reinterpret_cast<int32_t*>(dec);
      consumers_sync();  // every wgmma retired, earlier readers done
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ar + 8 * h;
          const int c = 8 * i + 2 * t;
          tr[r * (TILE + 1) + c] = acc[q][4 * i + 2 * h];
          tr[r * (TILE + 1) + c + 1] = acc[q][4 * i + 2 * h + 1];
        }
      consumers_sync();
      int32_t* base = out + static_cast<size_t>(mir) * nr * nc;
      for (int idx = tid; idx < TILE * TILE; idx += CONSUMERS) {
        const int c = idx / TILE;
        const int r = idx % TILE;
        if (col0 + c < nr && row0 + r < nc)
          base[static_cast<size_t>(col0 + c) * nc + row0 + r] =
              tr[r * (TILE + 1) + c];
      }
    }
  }
  consumers_sync();  // the decode buffers are free for the next item
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 1)
packed_gram_wgmma(const uint8_t* __restrict__ rows,
                  const uint8_t* __restrict__ cols, int32_t* __restrict__ out,
                  Geometry geo, Plan plan) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* dec = smem;
  uint8_t* ring = smem + DEC_BUFS * DEC_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * RING_STAGE);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], PRODUCERS);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
  }
  __syncthreads();

  // One branch a role, never rejoined, so that setmaxnreg holds: the
  // producers give registers back and the consumers take them (384
  // threads leave ptxas 168 a thread, too few for two accumulator sets
  // and the A fragments in flight).
  int s = 0;  // stages this block has passed through the ring
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int p = threadIdx.x - CONSUMERS;
    for (int item = blockIdx.x; item < geo.items; item += gridDim.x) {
      int sweep, ti, tj;
      item_tile(geo, item, sweep, ti, tj);
      const Copies copies = item_copies(rows, cols, ti * TILE, tj * TILE,
                                        geo.nr, geo.nc, geo.w, p);
      for (int kc = 0; kc < geo.nk; ++kc, ++s) {
        const int slot = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[slot], ((s / STAGES) - 1) & 1);
        load_stage<ALIGNED>(ring + slot * RING_STAGE, copies, geo.w, kc, p);
        if constexpr (ALIGNED)
          cp_async_arrive(&full[slot]);
        else
          mbar_arrive(&full[slot]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    for (int item = blockIdx.x; item < geo.items; item += gridDim.x) {
      int sweep, ti, tj;
      item_tile(geo, item, sweep, ti, tj);
      const int q0 = G_MAX * sweep;
      if (plan.n - q0 >= 2)
        consume_item<2>(geo, plan, out, dec, ring, full, empty, q0, ti, tj,
                        s);
      else
        consume_item<1>(geo, plan, out, dec, ring, full, empty, q0, ti, tj,
                        s);
    }
  }
}

template <bool ALIGNED>
cudaError_t launch(const uint8_t* rows, const uint8_t* cols, int32_t* out,
                   const Geometry& geo, const Plan& plan, int grid,
                   cudaStream_t stream) {
  auto kernel = packed_gram_wgmma<ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, SMEM, stream>>>(rows, cols, out, geo, plan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the launch's CUDA error (0 = launched).
// The plan holds `nq` contractions: operand codes `left`, `right` (0 = c,
// 1 = t1, 2 = t2, 3 = y) and the product indices `direct` (tile written
// at [I, J]) and `mirror` (written transposed at [J, I]; symmetric
// launches only), -1 for none. `out` is (products, nr, nc) int32.
// `symmetric` requires rows == cols.
int packed_gram_products(const void* rows, const void* cols, void* out,
                         int nr, int nc, int w, int nq, const int* left,
                         const int* right, const int* direct,
                         const int* mirror, int symmetric, void* stream) {
  if (nq < 1 || nq > MAX_CONTRACTIONS || nr < 1 || nc < 1 || w < 0 ||
      (symmetric && (nr != nc || rows != cols)))
    return static_cast<int>(cudaErrorInvalidValue);
  // Byte k of an operand's lookup word is its value for code k: c, t1,
  // t2, y (code 3, missing, is 0 in every operand).
  constexpr uint32_t lut[N_OPERANDS] = {0x00010101u, 0x00010100u,
                                        0x00010000u, 0x00020100u};
  Plan plan{};
  plan.n = nq;
  for (int q = 0; q < nq; ++q) {
    if (left[q] < 0 || left[q] >= N_OPERANDS || right[q] < 0 ||
        right[q] >= N_OPERANDS || direct[q] < -1 ||
        direct[q] >= MAX_PRODUCTS || mirror[q] < -1 ||
        mirror[q] >= MAX_PRODUCTS)
      return static_cast<int>(cudaErrorInvalidValue);
    plan.lut_left[q] = lut[left[q]];
    plan.lut_right[q] = lut[right[q]];
    plan.direct[q] = direct[q];
    plan.mirror[q] = mirror[q];
  }
  // The launch geometry: ops/packed_gram.py::launch_plan.
  Geometry geo{};
  geo.nr = nr;
  geo.nc = nc;
  geo.w = w;
  geo.symmetric = symmetric;
  const long long tiles_r = (nr + TILE - 1) / TILE;
  const long long tiles_c = (nc + TILE - 1) / TILE;
  const long long tiles = symmetric ? tiles_r * (tiles_r + 1) / 2
                                    : tiles_r * tiles_c;
  const long long items = tiles * ((nq + G_MAX - 1) / G_MAX);
  if (items > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  geo.tiles_c = static_cast<int>(tiles_c);
  geo.tiles = static_cast<int>(tiles);
  geo.nk = w > 0 ? (w + KB - 1) / KB : 1;
  geo.items = static_cast<int>(items);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);

  const auto* r = static_cast<const uint8_t*>(rows);
  const auto* c = static_cast<const uint8_t*>(cols);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = w % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  err = aligned ? launch<true>(r, c, o, geo, plan, grid, s)
                : launch<false>(r, c, o, geo, plan, grid, s);
  return static_cast<int>(err);
}

const char* packed_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
