// Packed-gram contraction for Hopper (sm_90a): 2-bit packed genotype
// bytes in, one int32 pair-count matrix per requested product out.
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
// the TPU kernel and to the unpack-then-contract reference whatever order
// the variants are summed in: no per-plane split is needed.
//
// What bounds it. At the main path's shape (2504 x 2504 samples, 2048
// bytes = 8192 variants, the 4 ibs products) the work is 4.1e11 int8
// operations against 5 MB read and 100 MB written: bound by operations
// (0.21 ms at the card's 1,979 TOP/s int8 tensor-core peak; the bytes
// take 0.03 ms at 3.35 TB/s).
//
// What this design does about it. This first version runs on the CUDA
// cores, not the tensor cores: __dp4a sums four int8 products into an
// int32 in one instruction, so one 32-bit word of decoded indicators
// covers one packed byte (four variants). A 256-thread block owns a 64 x 64
// output tile and walks the byte axis in 16-byte chunks inside the block
// (the TPU kernel's sequential k grid axis). Each chunk's bytes are read
// once from global memory (an out-of-range row, column or byte reads as
// 0xFF, four missing codes, which decode to zero in every operand), decoded
// once into all four operand words, and kept in shared memory, where every
// one of the block's 64 x 64 pairs reuses them. Each thread then holds a
// 4 x 4 sub-tile of accumulators per product in registers. The decode is
// thus amortised over 64 reuses and the inner loop is loads from shared
// memory and dp4a. The tensor-core route (mma.sync / wgmma on int8 tiles
// fed by TMA) is what reaches the operation bound, and is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // row samples per block
constexpr int BN = 64;          // column samples per block
constexpr int KB = 16;          // packed bytes per staged chunk
constexpr int THREADS = 256;
constexpr int TM = 4;           // accumulator rows per thread
constexpr int TN = 4;           // accumulator cols per thread
constexpr int N_OPERANDS = 4;   // c, t1, t2, y (the Python side's codes)
constexpr int MAX_PRODUCTS = 7;

static_assert((BM / TM) * (BN / TN) == THREADS, "one sub-tile per thread");
static_assert(BM == BN, "one staging role covers rows and cols");
static_assert((THREADS / BM) * 4 == KB, "four bytes staged per thread");

struct ProductSet {
  int left[MAX_PRODUCTS];
  int right[MAX_PRODUCTS];
};

// One packed byte -> four operand words, one int8 lane per variant.
__device__ __forceinline__ void decode_byte(uint32_t byte,
                                            uint32_t (&op)[N_OPERANDS]) {
  // Spread the four 2-bit codes into the low bits of the four byte lanes.
  const uint32_t codes =
      (byte | (byte << 6) | (byte << 12) | (byte << 18)) & 0x03030303u;
  const uint32_t lo = codes & 0x01010101u;
  const uint32_t hi = (codes >> 1) & 0x01010101u;
  const uint32_t t1 = hi ^ lo;                     // code 1 or 2
  const uint32_t t2 = hi & ~lo;                    // code 2
  op[0] = ~(hi & lo) & 0x01010101u;                // c: code != 3
  op[1] = t1;
  op[2] = t2;
  op[3] = t1 + t2;                                 // y, lanes <= 2: no carry
}

template <int NP>
__global__ void __launch_bounds__(THREADS)
packed_gram_kernel(const uint8_t* __restrict__ rows,
                   const uint8_t* __restrict__ cols,
                   int32_t* __restrict__ out, int nr, int nc, int w,
                   ProductSet ps) {
  __shared__ __align__(16) uint32_t sa[N_OPERANDS][KB][BM];
  __shared__ __align__(16) uint32_t sb[N_OPERANDS][KB][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // Staging role: sample s of the tile, bytes q*4 .. q*4+3 of the chunk.
  const int s = tid % BM;
  const int q = tid / BM;
  const bool row_ok = row0 + s < nr;
  const bool col_ok = col0 + s < nc;
  const uint8_t* rp = rows + static_cast<size_t>(row_ok ? row0 + s : 0) * w;
  const uint8_t* cp = cols + static_cast<size_t>(col_ok ? col0 + s : 0) * w;

  // Compute role: rows ty*TM .., cols tx*TN .. of the tile.
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  int acc[NP][TM][TN];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][i][j] = 0;

  for (int k0 = 0; k0 < w; k0 += KB) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = q * 4 + i;
      const int k = k0 + kk;
      const uint32_t a = (row_ok && k < w) ? rp[k] : 0xFFu;
      const uint32_t b = (col_ok && k < w) ? cp[k] : 0xFFu;
      uint32_t da[N_OPERANDS], db[N_OPERANDS];
      decode_byte(a, da);
      decode_byte(b, db);
#pragma unroll
      for (int o = 0; o < N_OPERANDS; ++o) {
        sa[o][kk][s] = da[o];
        sb[o][kk][s] = db[o];
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint4 av =
            *reinterpret_cast<const uint4*>(&sa[ps.left[p]][kk][ty * TM]);
        const uint4 bv =
            *reinterpret_cast<const uint4*>(&sb[ps.right[p]][kk][tx * TN]);
        const int a4[TM] = {static_cast<int>(av.x), static_cast<int>(av.y),
                            static_cast<int>(av.z), static_cast<int>(av.w)};
        const int b4[TN] = {static_cast<int>(bv.x), static_cast<int>(bv.y),
                            static_cast<int>(bv.z), static_cast<int>(bv.w)};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[p][i][j] = __dp4a(a4[i], b4[j], acc[p][i][j]);
      }
    }
    __syncthreads();
  }

  // Out is (NP, nr, nc) int32, contiguous and 16-byte aligned.
  const bool vec = (nc % 4) == 0;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    int32_t* base = out + static_cast<size_t>(p) * nr * nc;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty * TM + i;
      if (r >= nr) continue;
      const int c0 = col0 + tx * TN;
      int32_t* dst = base + static_cast<size_t>(r) * nc + c0;
      if (vec && c0 + TN <= nc) {
        *reinterpret_cast<int4*>(dst) =
            make_int4(acc[p][i][0], acc[p][i][1], acc[p][i][2], acc[p][i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (c0 + j < nc) dst[j] = acc[p][i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched). `left` and
// `right` hold `np` operand codes each: 0 = c, 1 = t1, 2 = t2, 3 = y.
int packed_gram_products(const void* rows, const void* cols, void* out,
                         int nr, int nc, int w, int np, const int* left,
                         const int* right, void* stream) {
  if (np < 1 || np > MAX_PRODUCTS || nr < 1 || nc < 1 || w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ProductSet ps{};
  for (int p = 0; p < np; ++p) {
    if (left[p] < 0 || left[p] >= N_OPERANDS || right[p] < 0 ||
        right[p] >= N_OPERANDS)
      return static_cast<int>(cudaErrorInvalidValue);
    ps.left[p] = left[p];
    ps.right[p] = right[p];
  }
  const dim3 grid((nc + BN - 1) / BN, (nr + BM - 1) / BM);
  const auto* r = static_cast<const uint8_t*>(rows);
  const auto* c = static_cast<const uint8_t*>(cols);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 1: packed_gram_kernel<1><<<grid, THREADS, 0, s>>>(r, c, o, nr, nc, w, ps); break;
    case 2: packed_gram_kernel<2><<<grid, THREADS, 0, s>>>(r, c, o, nr, nc, w, ps); break;
    case 3: packed_gram_kernel<3><<<grid, THREADS, 0, s>>>(r, c, o, nr, nc, w, ps); break;
    case 4: packed_gram_kernel<4><<<grid, THREADS, 0, s>>>(r, c, o, nr, nc, w, ps); break;
    case 5: packed_gram_kernel<5><<<grid, THREADS, 0, s>>>(r, c, o, nr, nc, w, ps); break;
    case 6: packed_gram_kernel<6><<<grid, THREADS, 0, s>>>(r, c, o, nr, nc, w, ps); break;
    default: packed_gram_kernel<7><<<grid, THREADS, 0, s>>>(r, c, o, nr, nc, w, ps); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* packed_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
