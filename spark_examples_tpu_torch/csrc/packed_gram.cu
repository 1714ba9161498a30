// Packed-gram contraction for Hopper (sm_90a): 2-bit packed genotype
// bytes in, one int32 pair-count matrix per requested product out, on the
// int8 tensor cores.
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
// What bounds it. At the main path's shape (2504 samples, 2048 bytes =
// 8192 variants, the 4 ibs products) the work the output needs is 2.6e11
// int8 operations (3 symmetric products over the i <= j half, yc over the
// square) against 5 MB read and 100 MB written: bound by operations
// (0.13 ms at the card's 1,979 TOP/s int8 tensor-core peak).
//
// What this design does about it.
// - Tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32): each 32-bit
//   A or B fragment register holds four k values of one row, i.e. four
//   variants. Shared memory holds only
//   packed bytes (4x fewer than int8 operands). Each lane reads one 32-bit
//   word (16 variants) per row and 16-byte chunk and turns it into four
//   PRMT selectors: nibble n of (word & 0x33333333) is the code of variant
//   2n, nibble n of ((word >> 2) & 0x33333333) that of variant 2n+1. One
//   PRMT against a 4-byte lookup word per operand (byte k = the operand's
//   value for code k) then yields the fragment register. Both operands of
//   a contraction use the same selectors, so A and B agree on which
//   variant sits in which k lane. The lookup words make the operand of
//   every contraction a runtime choice at no cost. Chosen over decoding
//   into int8 tiles for ldmatrix (4x the shared memory traffic) and over
//   wgmma (B would have to be decoded into shared memory); wgmma + TMA
//   is the next step (ROADMAP Queue 2).
// - A ragged byte tail is masked in the selectors: OR-ing 0x4 into a
//   nibble selects a byte of the zero word, so bytes past w contribute
//   nothing whatever shared memory holds there. Out-of-range rows and
//   columns are never loaded: their accumulators are garbage and are
//   never stored.
// - Staging: 16-byte cp.async copies (a sample's bytes are contiguous, so
//   four lanes read one row's 64-byte stage chunk) into a ring of 3
//   stages, one barrier per stage. A width that is not a multiple of 16,
//   or an unaligned pointer, takes plain byte loads into the same ring.
// - Symmetric launches (rows and cols the same tensor, as the gram update
//   passes them) run only the tiles with I <= J, from a linear block
//   index. The launch carries a plan of contractions (built in Python,
//   ops/packed_gram.py::contraction_plan): each contraction (L, R) writes
//   its tile to [I, J] of product `direct` and its transpose to [J, I] of
//   product `mirror`. (L, L) products are their own mirror; an (L, R)
//   product takes its [J, I] tile from the partner contraction (R, L),
//   since out[j][i] = sum L_j R_i. The diagonal tile is written once.
//   Transposed stores go through a padded shared tile so they coalesce.
// - Registers: each contraction holds 32 int32 accumulators a thread.
//   The contractions run in groups of G (a template parameter), one sweep
//   over the bytes per group, so that ptxas spills nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KB = 64;               // packed bytes per stage (256 variants)
constexpr int PIECES = KB / 16;      // 16-byte chunks per row per stage
constexpr int STAGES = 3;
constexpr int N_OPERANDS = 4;        // c, t1, t2, y (the Python side's codes)
constexpr int MAX_PRODUCTS = 7;
constexpr int MAX_CONTRACTIONS = 2 * MAX_PRODUCTS;

// A 64 x 64 output tile per block (820 blocks at 2504 samples; a 128 tile
// ran ibs at the same speed on an H100, PERF.md): 2 x 2 warps, each owning
// 32 x 32 outputs as 2 x 4 m16n8 fragments.
constexpr int TILE = 64;
constexpr int WARPS_N = 2;
constexpr int THREADS = 128;
constexpr int WM = 32;               // rows a warp
constexpr int MT = WM / 16;          // m16 fragments a warp
constexpr int NT = 4;                // n8 fragments a warp (32 columns)
constexpr int STAGE_BYTES = 2 * TILE * KB;
constexpr int SMEM = STAGES * STAGE_BYTES + TILE * (TILE + 1) * 4;
static_assert(THREADS == 32 * 2 * WARPS_N && WARPS_N * 32 == TILE &&
                  2 * WM == TILE, "2 x 2 warps of 32 x 32");
static_assert((2 * TILE * PIECES) % THREADS == 0, "whole copies a thread");

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: TILE rows of `rows` and TILE rows of `cols`, bytes
// kc*KB .. kc*KB + KB, stored as [side][piece][sample][16 bytes] so that
// the fragment reads (8 samples x 4 words a warp) hit 32 distinct banks.
template <bool ALIGNED>
__device__ __forceinline__ void load_stage(uint8_t* dst, const uint8_t* rows,
                                           const uint8_t* cols, int row0,
                                           int col0, int nr, int nc, int w,
                                           int kc, int tid) {
#pragma unroll
  for (int i = 0; i < 2 * TILE * PIECES / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int piece = idx % PIECES;
    const int r = (idx / PIECES) % TILE;
    const int side = idx / (PIECES * TILE);
    const int sample = (side ? col0 : row0) + r;
    const int k = kc * KB + piece * 16;
    if (sample >= (side ? nc : nr) || k >= w) continue;
    const uint8_t* src = (side ? cols : rows) + static_cast<size_t>(sample) * w;
    uint8_t* d = dst + side * (TILE * KB) + (piece * TILE + r) * 16;
    if constexpr (ALIGNED) {
      cp_async16(d, src + k);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = k + 4 * q + e;
          const uint32_t byte = kk < w ? src[kk] : 0xFFu;
          v[q] |= byte << (8 * e);
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
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
// mask `m` (0x4 in every nibble of a byte past w) applied: [0] and [1]
// feed the first m16n8k32 step's k slots t and t + 4, [2] and [3] the
// second's. PRMT reads only the low 16 bits of a selector.
__device__ __forceinline__ void selectors(uint32_t word, uint32_t m,
                                          uint32_t (&s)[4]) {
  const uint32_t even = (word & 0x33333333u) | m;
  const uint32_t odd = ((word >> 2) & 0x33333333u) | m;
  s[0] = even;
  s[1] = odd;
  s[2] = even >> 16;
  s[3] = odd >> 16;
}

template <int G, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
packed_gram_mma(const uint8_t* __restrict__ rows,
                const uint8_t* __restrict__ cols, int32_t* __restrict__ out,
                int nr, int nc, int w, int symmetric, Plan plan) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* tr = reinterpret_cast<int32_t*>(smem + STAGES * STAGE_BYTES);

  // The block's tile: (I, J) with I <= J from a linear index when
  // symmetric, row-major over the grid otherwise.
  const int tiles_c = (nc + TILE - 1) / TILE;
  int ti, tj;
  if (symmetric) {
    int b = blockIdx.x;
    ti = 0;
    while (b >= tiles_c - ti) {
      b -= tiles_c - ti;
      ++ti;
    }
    tj = ti + b;
  } else {
    ti = blockIdx.x / tiles_c;
    tj = blockIdx.x % tiles_c;
  }
  const int row0 = ti * TILE;
  const int col0 = tj * TILE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (tid >> 5) / WARPS_N;
  const int wn = (tid >> 5) % WARPS_N;

  const int nk = w > 0 ? (w + KB - 1) / KB : 1;
  const int ngroups = (plan.n + G - 1) / G;
  const int total = nk * ngroups;

  int acc[G][MT][NT][4];
  uint32_t la[G], lb[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    la[q] = plan.lut_left[q];
    lb[q] = plan.lut_right[q];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mi][ni][e] = 0;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total)
      load_stage<ALIGNED>(smem + s * STAGE_BYTES, rows, cols, row0,
                                col0, nr, nc, w, s % nk, tid);
    cp_async_commit();
  }

  for (int step = 0; step < total; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < total)
      load_stage<ALIGNED>(smem + (next % STAGES) * STAGE_BYTES,
                                rows, cols, row0, col0, nr, nc, w, next % nk,
                                tid);
    cp_async_commit();

    const int kc = step % nk;
    const int grp = step / nk;
    const uint8_t* sa = smem + (step % STAGES) * STAGE_BYTES;
    const uint8_t* sb = sa + TILE * KB;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      const int left = w - (kc * KB + p * 16 + 4 * t);  // bytes of w left
      const uint32_t m =
          left >= 4 ? 0u : (left <= 0 ? 0x44444444u : 0x44444444u << (8 * left));
      uint32_t sel_a[MT][2][4];
      uint32_t sel_b[NT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          selectors(*reinterpret_cast<const uint32_t*>(
                        sa + (p * TILE + wm * WM + mi * 16 + 8 * h + g) * 16 +
                        4 * t),
                    m, sel_a[mi][h]);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        selectors(*reinterpret_cast<const uint32_t*>(
                      sb + (p * TILE + wn * 32 + ni * 8 + g) * 16 + 4 * t),
                  m, sel_b[ni]);
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
#pragma unroll
        for (int q = 0; q < G; ++q) {
          if (grp * G + q >= plan.n) continue;
          uint32_t a[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            a[mi][0] = lookup(la[q], sel_a[mi][0][2 * k2]);
            a[mi][1] = lookup(la[q], sel_a[mi][1][2 * k2]);
            a[mi][2] = lookup(la[q], sel_a[mi][0][2 * k2 + 1]);
            a[mi][3] = lookup(la[q], sel_a[mi][1][2 * k2 + 1]);
          }
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            const uint32_t b0 = lookup(lb[q], sel_b[ni][2 * k2]);
            const uint32_t b1 = lookup(lb[q], sel_b[ni][2 * k2 + 1]);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
              mma_s8(acc[q][mi][ni], a[mi], b0, b1);
          }
        }
      }
    }

    if (kc != nk - 1) continue;
    // The group's sweep is done: store its contractions, reset, and load
    // the next group's lookup words.
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int cq = grp * G + q;
      if (cq >= plan.n) continue;
      const int dst = pick(plan.direct, cq);
      if (dst >= 0) {
        int32_t* base = out + static_cast<size_t>(dst) * nr * nc;
        const bool pair = (nc % 2) == 0;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = row0 + wm * WM + mi * 16 + 8 * h + g;
              const int c = col0 + wn * 32 + ni * 8 + 2 * t;
              if (r >= nr || c >= nc) continue;
              int32_t* o = base + static_cast<size_t>(r) * nc + c;
              if (pair) {
                *reinterpret_cast<int2*>(o) =
                    make_int2(acc[q][mi][ni][2 * h], acc[q][mi][ni][2 * h + 1]);
              } else {
                o[0] = acc[q][mi][ni][2 * h];
                if (c + 1 < nc) o[1] = acc[q][mi][ni][2 * h + 1];
              }
            }
      }
      const int mir = pick(plan.mirror, cq);
      if (symmetric && mir >= 0 && ti != tj) {
        __syncthreads();  // the previous transpose's readers are done
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * WM + mi * 16 + 8 * h + g;
              const int c = wn * 32 + ni * 8 + 2 * t;
              tr[r * (TILE + 1) + c] = acc[q][mi][ni][2 * h];
              tr[r * (TILE + 1) + c + 1] = acc[q][mi][ni][2 * h + 1];
            }
        __syncthreads();
        int32_t* base = out + static_cast<size_t>(mir) * nr * nc;
        for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
          const int c = idx / TILE;
          const int r = idx % TILE;
          if (col0 + c < nr && row0 + r < nc)
            base[static_cast<size_t>(col0 + c) * nc + row0 + r] =
                tr[r * (TILE + 1) + c];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][mi][ni][e] = 0;
      la[q] = pick(plan.lut_left, cq + G);
      lb[q] = pick(plan.lut_right, cq + G);
    }
  }
  cp_async_wait<0>();
}

template <int G, bool ALIGNED>
cudaError_t launch(const uint8_t* rows, const uint8_t* cols, int32_t* out,
                   int nr, int nc, int w, int symmetric, const Plan& plan,
                   cudaStream_t stream) {
  auto kernel = packed_gram_mma<G, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long tr = (nr + TILE - 1) / TILE;
  const long long tc = (nc + TILE - 1) / TILE;
  const long long blocks = symmetric ? tr * (tr + 1) / 2 : tr * tc;
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(
      rows, cols, out, nr, nc, w, symmetric, plan);
  return cudaGetLastError();
}

template <bool ALIGNED>
cudaError_t dispatch_groups(const uint8_t* r, const uint8_t* c, int32_t* o,
                            int nr, int nc, int w, int symmetric,
                            const Plan& plan, cudaStream_t s) {
  // 32 accumulators a thread per contraction: groups of at most 3 leave
  // ptxas room (4 take 255 registers and spill). The groups are
  // balanced: 5 contractions run as 3 + 2.
  constexpr int G_MAX = 3;
  const int sweeps = (plan.n + G_MAX - 1) / G_MAX;
  switch ((plan.n + sweeps - 1) / sweeps) {
    case 1: return launch<1, ALIGNED>(r, c, o, nr, nc, w, symmetric, plan, s);
    case 2: return launch<2, ALIGNED>(r, c, o, nr, nc, w, symmetric, plan, s);
    default: return launch<3, ALIGNED>(r, c, o, nr, nc, w, symmetric, plan, s);
  }
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
  const auto* r = static_cast<const uint8_t*>(rows);
  const auto* c = static_cast<const uint8_t*>(cols);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = w % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const cudaError_t err =
      aligned ? dispatch_groups<true>(r, c, o, nr, nc, w, symmetric, plan, s)
              : dispatch_groups<false>(r, c, o, nr, nc, w, symmetric, plan, s);
  return static_cast<int>(err);
}

const char* packed_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
